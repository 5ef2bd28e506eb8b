"""AdamW with an optional bf16 state, a cosine schedule and gradient
clipping.

The port of the JAX package's ``repro/optim/optimizer.py``: the same
schedule, the same f32 arithmetic in the same order for each element, weight
decay on matrices only (``p.ndim >= 2``). ``step`` stays a 0-d int32 tensor
on the params' device, so the learning rate and the bias corrections are
computed there and the host never waits for them.

Where the JAX module maps one f32 update over each whole leaf, this one
walks each leaf in slices of at most ``SLICE`` elements and writes params, m
and v back in place: at qwen2-7b's width a stacked leaf holds 1.9e9
elements, and a whole-leaf f32 update would hold several 7.6-GB
temporaries. The update is elementwise, so the slices give the same bits;
``global_norm`` sums the slices' squares one after another, an order JAX
does not take (the tests' tolerance covers it). ``adamw_update`` returns
the same (mutated) param tree.

On a mesh m and v may split a dim over ``pod`` further than the param
(ZeRO across pods: the JAX package's optimizer-state rule,
``sharding.infer_param_spec(opt_state=True)``, as its dry run and elastic
restore place them; ``shard_opt_state``). Such a leaf's gradient is
reduce-scattered over ``pod`` to m's block (``scatter_grads``), the rank
updates that block of the param with its m and v, and the param is
all-gathered over ``pod`` again. Where ``pod`` is the slower axis of m's
dim (JAX's ``("pod", "data")``), a rank's block of m is not inside its
block of the param: a ``ppermute`` brings the gradient and the param's
values to it and the update back.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from repro_torch.parallel import sharding as shd

F32 = torch.float32
SLICE = 1 << 26    # elements a slice: ~1.9 GB of f32 temporaries at most


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    state_dtype: str = "float32"     # 'bfloat16' halves optimizer memory

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def leaves(tree) -> list:
    """The tree's tensors (None too) in the JAX package's flatten order:
    dict keys sorted, lists by index."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def lr_at(cfg: OptimizerConfig, step):
    """The learning rate at ``step`` (a tensor: a 0-d f32 tensor on its
    device; a number: a CPU one), as the JAX schedule computes it."""
    step = step.to(F32) if isinstance(step, torch.Tensor) else \
        torch.tensor(float(step), dtype=F32)
    warm = cfg.lr * torch.clamp((step + 1) / max(cfg.warmup_steps, 1),
                                max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def _zeros(p, dt):
    """Zeros like ``p`` in ``dt``: a ``Sharded`` leaf's like its shards."""
    if isinstance(p, shd.Sharded):
        return p.map(lambda s: torch.zeros(s.shape, dtype=dt,
                                           device=s.device))
    return torch.zeros(p.shape, dtype=dt, device=p.device)


def init_opt_state(params, cfg: OptimizerConfig):
    """m and v like the params (a mesh's ``Sharded`` leaves block by block,
    as the params, as JAX's fresh training holds them), and the step.
    ``shard_opt_state`` places them by the optimizer-state rule."""
    dt = getattr(torch, cfg.state_dtype)
    first = next(x for x in leaves(params) if x is not None)
    return {"m": tree_map(lambda p: _zeros(p, dt), params),
            "v": tree_map(lambda p: _zeros(p, dt), params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def shard_opt_state(opt_state, mesh, layout: str = None):
    """A whole optimizer state with m and v split by the optimizer-state
    rule (``shard_params(..., opt_state=True)``: the param's spec plus
    ``pod`` on the fsdp dim), the step as it is."""
    return {k: shd.shard_params(opt_state[k], mesh, opt_state=True,
                                layout=layout) if k in ("m", "v")
            else opt_state[k] for k in opt_state}


# ------------------------------------------------------- ZeRO across pods
def pod_dim(p, m):
    """The dim along which a rank's block ``m`` of the optimizer state
    splits its block ``p`` of the param further over ``pod``, or None when
    m is held as the param is (their specs, ``sharding.spec_of``)."""
    ps = shd._full_spec(shd.spec_of(p), p.dim())
    ms = shd._full_spec(shd.spec_of(m), m.dim())
    if ps == ms:
        return None
    diff = [d for d in range(len(ps)) if ps[d] != ms[d]]
    d = diff[0]
    if len(diff) != 1 or "pod" in ps[d] or \
            tuple(a for a in ms[d] if a != "pod") != ps[d]:
        raise ValueError(f"m's spec {shd.spec_of(m)} is not the param's "
                         f"{shd.spec_of(p)} with 'pod' added on one dim")
    return d


def pod_dims(params, m) -> list:
    """``pod_dim`` of every leaf of a rank's trees, in flatten order."""
    return [None if p is None else pod_dim(p, mm)
            for p, mm in zip(leaves(params), leaves(m))]


def _to_m_block(comm, x, p, m, d, back: bool = False):
    """``x``, this rank's sub-block ``pod`` of its block of the param along
    ``d`` (the order a reduce-scatter over ``pod`` gives, ``pod``
    fastest), moved to the rank whose block of m it is (``back``: the
    inverse move). Where ``pod`` is the fastest axis of m's dim too, or
    the other axes of the dim are of size 1, that is this rank."""
    src = shd._full_spec(shd.spec_of(p), p.dim())[d] + ("pod",)
    dst = shd._full_spec(shd.spec_of(m), m.dim())[d]
    axes = tuple(a for a in comm.axis_names if a in dst)
    line = comm.mesh.line(comm.rank, axes)
    where = {comm.mesh.axis_index(r, dst): i for i, r in enumerate(line)}
    perm = [(i, where[comm.mesh.axis_index(r, src)])
            for i, r in enumerate(line)]
    if all(s == t for s, t in perm):
        return x
    if back:
        perm = [(t, s) for s, t in perm]
    return comm.ppermute(x, axes, perm)


def scatter_grads(comm, grads, params, m, zero,
                  summed: bool = False) -> list:
    """Rank ``comm.rank``'s gradients (a list in flatten order) with each
    leaf whose m splits over ``pod`` further (``zero``, the leaves'
    ``pod_dims``) cut to m's block: reduce-scattered over ``pod``
    (``summed``: the gradient is the pods' sum already, its block taken)
    and moved to m's owner. The other leaves as they are."""
    out = []
    for g, p, mm, d in zip(grads, leaves(params), leaves(m), zero):
        if g is not None and d is not None:
            g = shd.block(g, d, comm.shape["pod"], comm.axis_index("pod")) \
                if summed else comm.psum_scatter(g, "pod", d)
            g = shd.set_spec(_to_m_block(comm, g, p, mm, d).contiguous(),
                             shd.spec_of(mm))
        out.append(g)
    return out


def _slices(x):
    if not x.is_contiguous():
        raise ValueError("adamw_update: every leaf must be contiguous (its "
                         "slices are updated in place)")
    flat = x.view(-1)
    for i in range(0, flat.numel(), SLICE):
        yield flat[i:i + SLICE]


def global_norm(tree, mesh=None, specs=None):
    """sqrt of the sum of every element's square, in f32 (a None leaf
    counts as zeros). Under a mesh (a rank's ``dist.MeshComm``; ``specs``
    the leaves' specs in flatten order) each leaf is a rank's block: the
    squares are summed by the axes the blocks split, and one ``psum`` over
    each set of axes gives the whole tree's norm on every rank."""
    xs = leaves(tree)
    first = next(x for x in xs if x is not None)
    if mesh is None:
        specs = [()] * len(xs)
    groups = {}
    for x, spec in zip(xs, specs):
        if x is None:
            continue
        named = {a for e in spec if e for a in ((e,) if isinstance(e, str)
                                               else e)}
        axes = tuple(a for a in (mesh.axis_names if mesh is not None else ())
                     if a in named)
        total = groups.get(axes, torch.zeros((), dtype=F32,
                                             device=first.device))
        for part in _slices(x):
            total = total + torch.sum(torch.square(part.to(F32)))
        groups[axes] = total
    total = torch.zeros((), dtype=F32, device=first.device)
    for axes in sorted(groups):
        part = groups[axes]
        total = total + (mesh.psum(part, axes) if axes else part)
    return torch.sqrt(total)


def _update(p, g, m, v, scale, lr, c1, c2, cfg: OptimizerConfig,
            decay: bool):
    """One slice, in place: JAX's ``upd`` for each element."""
    g = g.to(F32) * scale
    mf = m.to(F32).mul_(cfg.b1).add_(g * (1 - cfg.b1))
    vf = v.to(F32).mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
    u = (mf / c1).div_((vf / c2).sqrt_().add_(cfg.eps))
    pf = p.to(F32)
    if decay:  # decoupled weight decay on matrices only
        u.add_(cfg.weight_decay * pf)
    p.copy_(pf.sub_(lr * u))
    m.copy_(mf)
    v.copy_(vf)


@torch.no_grad()
def adamw_update(params, grads, opt_state, cfg: OptimizerConfig, mesh=None,
                 zero=None):
    """Returns (params, new_opt_state, stats): params, m and v updated in
    place (a None grad is a zero one), the state's step one on. ``grads``
    is a tree like ``params`` or the list of its leaves in flatten order.
    Under a mesh (a rank's ``dist.MeshComm``) the trees are the rank's
    blocks and the clipping norm is the whole tree's; a leaf whose m splits
    over ``pod`` further than the param (``zero``, the leaves'
    ``pod_dims``) takes the gradient of m's block (``scatter_grads``), and
    its param is all-gathered over ``pod`` after the update."""
    step = opt_state["step"]
    if zero is None:
        zero = [None] * len(leaves(params))
    gn = global_norm(grads, mesh, [
        shd.spec_of(m if d is not None else p) for p, m, d in zip(
            leaves(params), leaves(opt_state["m"]), zero)])
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0) \
        if cfg.grad_clip > 0 else torch.ones((), dtype=F32, device=gn.device)
    lr = lr_at(cfg, step)
    c1 = 1.0 - cfg.b1 ** (step.to(F32) + 1)
    c2 = 1.0 - cfg.b2 ** (step.to(F32) + 1)
    for p, g, m, v, d in zip(leaves(params), leaves(grads),
                             leaves(opt_state["m"]), leaves(opt_state["v"]),
                             zero):
        if g is None:
            g = torch.zeros_like(m)
        if g.shape != m.shape or (d is None and m.shape != p.shape):
            raise ValueError(f"adamw_update: a gradient of shape "
                             f"{tuple(g.shape)} for m of {tuple(m.shape)} "
                             f"and a param of {tuple(p.shape)} (zero "
                             f"{d})")
        # the param's values at m's block, a copy of their own
        blk = p if d is None else _to_m_block(
            mesh, shd.block(p, d, mesh.shape["pod"], mesh.axis_index("pod")),
            p, m, d).clone(memory_format=torch.contiguous_format)
        for ps, gs, ms, vs in zip(_slices(blk), _slices(g), _slices(m),
                                  _slices(v)):
            _update(ps, gs, ms, vs, scale, lr, c1, c2, cfg, p.dim() >= 2)
        if d is not None:
            p.copy_(mesh.all_gather(_to_m_block(mesh, blk, p, m, d,
                                                back=True), "pod", d))
    new_state = {"m": opt_state["m"], "v": opt_state["v"], "step": step + 1}
    return params, new_state, {"grad_norm": gn, "lr": lr}
