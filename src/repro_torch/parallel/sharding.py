"""Sharding rules and the explicit partitioning of the LM stack on a mesh.

The rules are the JAX package's ``repro/parallel/sharding.py``, copied:

  batch             -> ('pod','data')  (pod folds into DP)
  weight "in" dim   -> 'data'   (FSDP row shard)   } only when the dim
  weight "out" dim  -> 'model'  (tensor col shard) } is large enough
  MoE expert dim    -> 'model'  (EP), fsdp dim 'data'
  optimizer m/v     -> like params, plus 'pod' on the fsdp dim (ZeRO across pods)

Small leaves (< ``_REPLICATE_BELOW`` elements) stay replicated; ``pad``
drops an axis that does not divide its dim. A spec is a ``P`` (a tuple, as
jax's ``PartitionSpec``); ``batch_sharding`` gives the spec of a batch.

GSPMD partitions the rest of the JAX model implicitly; PyTorch has nothing
that does, so the port partitions explicitly, rank by rank (each rank's code
gets its ``dist.MeshComm`` as ``mesh``):

- ``shard_params`` gives each rank only its block of each leaf, by the
  rule: a tree of ``Sharded`` leaves (the global array, one shard a rank);
  ``unshard`` assembles it again, ``local_tree`` is one rank's tree. A
  rank's tensor carries its leaf's spec (``spec_of``; ``sub_spec`` for the
  per-layer views of a stacked leaf).
- ``constrain`` slices a whole (replicated) tensor to this rank's block:
  the batch enters the model whole and is sliced there.
- ``as_spec`` brings a rank's tensor from its spec to another: all-gather
  the axes it drops, slice the axes it takes. The model code uses it for
  the ``tp`` layout's column-parallel weights (``model`` on the output dim),
  row-parallel ones (``model`` on the input dim, a ``psum`` over ``model``
  after the product), the FSDP (``data``) dim gathered before use, and for
  the ``fsdp`` layout, where every weight is gathered whole.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
import re
import torch

_REPLICATE_BELOW = 1 << 22          # 4M elements (~8MB bf16)

_mesh_var: contextvars.ContextVar = contextvars.ContextVar("repro_mesh",
                                                           default=None)
_layout_var: contextvars.ContextVar = contextvars.ContextVar("repro_layout",
                                                             default="tp")
# the share of the batch this rank holds, 1 / n: set where the batch enters
# the model (``constrain``), read where a whole-batch count is wanted (the
# MoE's token counts)
_rows_var: contextvars.ContextVar = contextvars.ContextVar("repro_rows",
                                                           default=1)


class P(tuple):
    """A partition spec: one entry a dim (None, an axis name or a tuple of
    them), missing trailing entries None, as jax's ``PartitionSpec``."""

    def __new__(cls, *entries):
        # as jax: a one-axis tuple is that axis, an empty one None
        entries = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else
                        (None if e == () else e) for e in entries)
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P" + tuple.__repr__(self)


@contextlib.contextmanager
def use_mesh(mesh, layout: str = None):
    """``mesh`` (a rank's ``dist.MeshComm``) and the layout for the code
    inside, in this thread: each rank of a ``LocalMesh`` runs in a thread of
    its own, so each enters it."""
    tok = _mesh_var.set(mesh)
    tok2 = _layout_var.set(layout) if layout else None
    try:
        yield mesh
    finally:
        _mesh_var.reset(tok)
        if tok2 is not None:
            _layout_var.reset(tok2)


def current_mesh():
    return _mesh_var.get()


def current_layout() -> str:
    return _layout_var.get()


def batch_axes(mesh, layout: str = None):
    layout = layout or current_layout()
    names = ("pod", "data", "model") if layout == "fsdp" else ("pod", "data")
    return tuple(a for a in names if a in mesh.axis_names)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _size(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def block(x, dim: int, n: int, i: int):
    """Block ``i`` of ``n`` of ``x`` along ``dim`` (a view)."""
    if n == 1:
        return x
    step = x.shape[dim] // n
    return x.narrow(dim, i * step, step)


def constrain(x, spec_axes, mesh=None):
    """This rank's block of a whole tensor ``x``: each dim whose entry names
    axes ('batch' is ``batch_axes``) is sliced over them where they divide
    it (a dim they do not divide stays whole, where GSPMD would pad). No
    mesh (the context's, or ``mesh``): ``x`` as it is. The port slices a
    tensor once, where it enters the model whole; a dim whose spec
    (``spec_of``) already names the axes is this rank's block already."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return x
    used = set()
    for dim, ax in enumerate(spec_axes):
        axes = batch_axes(mesh) if ax == "batch" else _entry_axes(ax)
        axes = tuple(a for a in axes if a not in used)   # each axis once
        used.update(axes)
        n = _size(mesh, axes)
        held = _full_spec(spec_of(x), x.dim())[dim]
        if axes and held == axes:       # a block already (a data pipeline's)
            sliced = True
        else:
            sliced = n > 1 and x.shape[dim] % n == 0
            if sliced:
                x = block(x, dim, n, mesh.axis_index(axes))
        if ax == "batch":
            _rows_var.set(n if sliced else 1)
    return x


def batch_split() -> int:
    """How many blocks the batch was cut into where it entered the model
    in this thread (1: every rank holds it whole)."""
    return _rows_var.get()


# ------------------------------------------------------------ param rules
_EXPERT3D = re.compile(r"(w_up|w_gate|w_down)$")
_COL = re.compile(r"(w_up|w_gate|wq|wk|wv|w_q|w_k|w_v|w_x|w_g|w_if|w)$")
_ROW = re.compile(r"(w_down|wo|w_out)$")


def _path_str(path) -> str:
    parts = []
    for k in path:
        if hasattr(k, "key"):
            parts.append(str(k.key))
        elif hasattr(k, "idx"):
            parts.append(str(k.idx))
        else:
            parts.append(str(k))
    return "/".join(parts)


def infer_param_spec(path, shape, mesh, *, opt_state=False,
                     layout: str = None) -> P:
    """Sharding rule for one parameter leaf, keyed on its name + rank."""
    layout = layout or current_layout()
    name = _path_str(path)
    # scanned models stack per-layer params under 'layers_stacked' (leading L dim)
    stacked = 1 if "layers_stacked" in name and len(shape) >= 2 else 0
    core = shape[stacked:]
    size = 1
    for s in shape:
        size *= s
    if size < _REPLICATE_BELOW or not core:
        return P()
    if layout == "fsdp":
        fsdp = tuple(a for a in (("pod", "data", "model") if opt_state
                                 else ("data", "model"))
                     if a in mesh.axis_names)
    else:
        fsdp = ("pod", "data") if (opt_state and "pod" in mesh.axis_names) \
            else "data"
    leaf_name = name.split("/")[-1]

    def _axes_size(ax):
        if ax is None:
            return 1
        axes = ax if isinstance(ax, tuple) else (ax,)
        out = 1
        for a in axes:
            out *= mesh.shape[a]
        return out

    def pad(spec_tail):
        # drop any axis whose size does not divide the dim (jit in_shardings
        # rejects uneven shards — e.g. whisper's 51865 vocab on a 16-way axis)
        fitted = [ax if core[i] % _axes_size(ax) == 0 else None
                  for i, ax in enumerate(spec_tail)]
        return P(*([None] * stacked + fitted))

    if len(core) == 3 and _EXPERT3D.search(leaf_name):   # experts (E, d, ff)
        ep_fsdp = "data" if not opt_state or "pod" not in mesh.axis_names \
            else ("pod", "data")
        return pad(["model", ep_fsdp, None])             # EP in both layouts
    if layout == "fsdp":                                 # pure row sharding
        if len(core) >= 2:
            return pad([fsdp] + [None] * (len(core) - 1))
        return P()
    if leaf_name == "table" and len(core) == 2:          # embedding (V, d)
        return pad(["model", fsdp])
    if len(core) == 2:
        if _ROW.search(leaf_name):
            return pad(["model", fsdp])                  # (ff, d): ff->model
        if _COL.search(leaf_name) or leaf_name == "router":
            return pad([fsdp, "model"])                  # (d, ff): ff->model
        return pad([fsdp, None])
    if len(core) == 1:
        return P()
    return P()


def _named(tree, path=()):
    if isinstance(tree, P):
        yield path, tree
    elif isinstance(tree, dict):
        for k in tree:
            yield from _named(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named(v, path + (i,))
    else:
        yield path, tree


def _map_named(fn, tree, path=()):
    if isinstance(tree, P):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_named(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def param_specs(tree, mesh, *, opt_state=False, layout: str = None):
    """The spec of every leaf of a params tree (JAX's
    ``make_param_shardings``, as specs)."""
    return _map_named(lambda path, x: None if x is None else
                      infer_param_spec(path, tuple(x.shape), mesh,
                                       opt_state=opt_state, layout=layout),
                      tree)


def batch_sharding(mesh, ndim: int, batch_dim=0, batch_size=None,
                   layout: str = None) -> P:
    """Shard dim ``batch_dim`` over the DP axes; replicate when the batch does
    not divide them (e.g. long_500k's global_batch=1)."""
    spec = [None] * ndim
    baxes = batch_axes(mesh, layout)
    bsz = math.prod(mesh.shape[a] for a in baxes) if baxes else 1
    if batch_size is None or (batch_size % max(bsz, 1) == 0
                              and batch_size >= bsz):
        spec[batch_dim] = baxes
    return P(*spec)


def replicated(mesh) -> P:
    return P()


# ------------------------------------------------------ explicit partitioning
_SPEC = "repro_spec"


def _full_spec(spec, ndim: int) -> tuple:
    spec = tuple(spec or ())
    return tuple(_entry_axes(e) for e in spec + (None,) * (ndim - len(spec)))


def spec_of(t) -> P:
    """The spec of a rank's tensor (replicated when it carries none)."""
    return getattr(t, _SPEC, None) or P()


def set_spec(t, spec):
    setattr(t, _SPEC, P(*spec))
    return t


def sub_spec(parent, piece, drop: int = 1):
    """``piece`` (a slice of ``parent`` along its first ``drop`` dims)
    carries the parent's spec without those dims."""
    spec = getattr(parent, _SPEC, None)
    if spec is not None:
        set_spec(piece, tuple(spec)[drop:])
    return piece


def shard_tensor(x, spec, mesh, rank: int):
    """Rank ``rank``'s block of the whole tensor ``x`` under ``spec`` (a
    view)."""
    for dim, axes in enumerate(_full_spec(spec, x.dim())):
        if axes:
            x = block(x, dim, _size(mesh, axes), mesh.axis_index(rank, axes))
    return x


def as_spec(w, mesh, target):
    """A rank's tensor ``w`` brought from its spec (``spec_of``) to
    ``target``: each dim whose axes change is all-gathered over its current
    axes (differentiably: the backward is a reduce-scatter) and sliced to
    this rank's block of the target's. Without a mesh ``w`` as it is."""
    if mesh is None:
        return w
    cur = _full_spec(spec_of(w), w.dim())
    tgt = _full_spec(target, w.dim())
    out = w
    for dim, (c, t) in enumerate(zip(cur, tgt)):
        if c == t:
            continue
        if c:
            out = mesh.all_gather(out, c, dim)
        if t:
            out = block(out, dim, _size(mesh, t), mesh.axis_index(t))
    if out is not w:
        set_spec(out, target)
    return out


def whole(w, mesh):
    """``w`` gathered whole."""
    return as_spec(w, mesh, P())


def gathered(tree, mesh):
    """Every tensor of a params subtree gathered whole (the blocks the port
    does not partition: the recurrent ones, the encoder-decoder)."""
    if mesh is None:
        return tree
    return _map_named(lambda _, x: x if not isinstance(x, torch.Tensor)
                      else whole(x, mesh), tree)


def model_split(w, dim: int):
    """Whether ``w`` holds only its ``model`` block along ``dim``."""
    return "model" in _full_spec(spec_of(w), w.dim())[dim]


class Sharded:
    """A global tensor held as one shard a rank: ``shards[r]`` is rank
    ``r``'s block under ``spec`` (None for a rank of another process).
    ``full()`` assembles it; ``copy_`` writes a whole tensor into the
    shards (a checkpoint's restore)."""

    def __init__(self, shards, spec, shape, mesh):
        self.shards = list(shards)
        self.spec = P(*spec)
        self.shape = torch.Size(shape)
        self.mesh = mesh

    def _any(self):
        return next(s for s in self.shards if s is not None)

    @property
    def dtype(self):
        return self._any().dtype

    @property
    def device(self):
        return self._any().device

    def dim(self) -> int:
        return len(self.shape)

    ndim = property(dim)

    def local(self, rank: int):
        return self.shards[rank]

    def map(self, fn) -> "Sharded":
        """A like ``Sharded`` of ``fn(shard)`` for each shard here."""
        return Sharded([None if s is None else set_spec(fn(s), self.spec)
                        for s in self.shards], self.spec, self.shape,
                       self.mesh)

    def _index(self, rank: int):
        idx = []
        for dim, axes in enumerate(_full_spec(self.spec, len(self.shape))):
            n = _size(self.mesh, axes) if axes else 1
            step = self.shape[dim] // n
            i = self.mesh.axis_index(rank, axes) if axes else 0
            idx.append(slice(i * step, (i + 1) * step))
        return tuple(idx)

    def full(self):
        out = torch.empty(self.shape, dtype=self.dtype, device=self.device)
        for r, s in enumerate(self.shards):
            if s is None:
                raise RuntimeError("Sharded.full: a shard lies in another "
                                   "process")
            out[self._index(r)] = s.detach()
        return out

    @torch.no_grad()
    def copy_(self, src, non_blocking: bool = False):
        for r, s in enumerate(self.shards):
            if s is not None:
                s.copy_(src[self._index(r)], non_blocking=non_blocking)
        return self


def shard_params(tree, mesh, *, opt_state=False, layout: str = None,
                 copy: bool = True, specs=None):
    """A params (or optimizer-state) tree as ``Sharded`` leaves: every rank
    of ``mesh`` in this process (``mesh.ranks``) gets its block of each
    leaf by the rule (or by ``specs``, a tree of specs), a contiguous copy
    of its own (``copy``) or a view of the whole leaf (the serving path's,
    which then holds one copy of the model for all ranks)."""
    specs = specs if specs is not None else param_specs(
        tree, mesh, opt_state=opt_state, layout=layout)
    flat = dict(_named(specs))

    def one(path, x):
        if not isinstance(x, torch.Tensor):
            return x
        spec = flat[path]
        shards = [None] * mesh.size
        for r in mesh.ranks:
            s = shard_tensor(x.detach(), spec, mesh, r)
            s = s.clone(memory_format=torch.contiguous_format) if copy \
                else s
            shards[r] = set_spec(s, spec)
        return Sharded(shards, spec, x.shape, mesh)
    return _map_named(one, tree)


def unshard(tree):
    """Every ``Sharded`` leaf assembled whole."""
    return _map_named(lambda _, x: x.full() if isinstance(x, Sharded) else x,
                      tree)


def local_tree(tree, rank: int):
    """Rank ``rank``'s tree: its shard of each ``Sharded`` leaf."""
    return _map_named(lambda _, x: x.local(rank) if isinstance(x, Sharded)
                      else x, tree)


def replicated_axes(t, mesh, skip=()) -> tuple:
    """The axes of ``mesh`` a rank's tensor ``t`` is not split over (its
    copies lie along them), but ``skip``."""
    named = {a for e in _full_spec(spec_of(t), t.dim()) for a in e}
    return tuple(a for a in mesh.axis_names
                 if a not in named and a not in skip)

