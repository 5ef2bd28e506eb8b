"""The LM's sharded paths against the JAX package's on meshes of host
devices (one JAX subprocess, 8 devices, ``repro.launch.mesh.make_mesh``):

- the MoE on arctic-480b's smoke config (stacked layers, capacity factor
  4, bf16) on a (data 2, model 4) mesh: the loss of ``local``,
  ``move_compute`` and ``move_data`` each within 2e-3 of JAX's for the same
  strategy; in f32 one MoE layer's output and aux within ``F32_TOL``, and
  every rank's expert ids, positions and drops (each rank's routing of its
  token slice; ``move_compute``'s owner side too) bit-equal;
- ``vocab_parallel_cross_entropy`` within 1e-5 of JAX's on (2, 2), the head
  held whole by the rule and split by it (a threshold of 0);
- split-KV decode on qwen2-7b's smoke config in f32 on (2, 2): the prefill
  and three decode steps' logits within 2e-3 of JAX's mesh decode, the
  attention replicated (the rule keeps the smoke weights whole) and
  column-parallel (every leaf split: a threshold of 0).
"""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_smoke_config as tget
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.parallel import sharding as shd

from _torch_mesh import F32_TOL, run_jax

STRATEGIES = ("local", "move_compute", "move_data")

JAX_CODE = """
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.models import build_model
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.parallel import sharding as shd
from repro.launch.mesh import make_mesh
from _torch_mesh import flat_names
out = {}
rng = np.random.default_rng(1)

def save_tree(prefix, tree):
    for name, leaf in flat_names(jax.device_get(tree)):
        out[prefix + name] = np.asarray(leaf, np.float32)

# ---- the MoE strategies' losses, bf16, (data 2, model 4)
mesh = make_mesh((2, 4), ("data", "model"))
cfg0 = get_smoke_config("arctic-480b").replace(scan_layers=True,
                                                capacity_factor=4.0)
params = build_model(cfg0).init(jax.random.key(0))
save_tree("arctic/", params)
toks = rng.integers(0, 512, (8, 32)).astype(np.int32)
out["arctic_tokens"] = toks
for strat in ("local", "move_compute", "move_data"):
    cfg = cfg0.replace(parallel=cfg0.parallel.replace(moe_strategy=strat))
    api = build_model(cfg)
    def step(p, b):
        with shd.use_mesh(mesh):
            return api.loss(p, b, mesh)
    loss, m = jax.jit(step)(params, {"tokens": jnp.asarray(toks)})
    out["loss_" + strat] = np.asarray(loss)
    out["aux_" + strat] = np.asarray(m["aux"])

# ---- one MoE layer in f32: outputs, and each rank's routing
cfg32 = cfg0.replace(dtype="float32", capacity_factor=1.25)
p32 = build_model(cfg32).init(jax.random.key(2))
moe_p = jax.tree.map(lambda a: a[0], p32["layers_stacked"]["moe"])
save_tree("moe/", moe_p)
x = rng.normal(size=(8, 16, cfg32.d_model)).astype(np.float32)
out["moe_x"] = x
for strat in ("move_compute", "move_data"):
    c = cfg32.replace(parallel=cfg32.parallel.replace(moe_strategy=strat))
    def f(p, xx):
        with shd.use_mesh(mesh):
            return jmoe.apply_moe(p, c, xx, mesh=mesh)
    y, aux = jax.jit(f)(moe_p, jnp.asarray(x))
    out["moe_y_" + strat], out["moe_aux_" + strat] = np.asarray(y), \
        np.asarray(aux)
x2d = x.reshape(-1, cfg32.d_model)
t_m = x2d.shape[0] // 2 // 4
e, k, p_sz = cfg32.num_experts, cfg32.top_k, 4
e_loc = e // p_sz
send_e = {}
for d in range(2):
    for m in range(4):
        xr = x2d[d * 4 * t_m:(d + 1) * 4 * t_m][m * t_m:(m + 1) * t_m]
        _, ex, _ = jmoe.topk_routing(moe_p["router"], jnp.asarray(xr), k)
        flat = np.asarray(ex).reshape(-1).astype(np.int32)
        out[f"ids_{d}{m}"] = flat
        out[f"pos_local_{d}{m}"] = np.asarray(jmoe.positions_within(
            jnp.asarray(flat), e))
        peer = flat // e_loc
        cap_p = jmoe._capacity(t_m, k, p_sz, cfg32.capacity_factor)
        pos_p = np.asarray(jmoe.positions_within(jnp.asarray(peer), p_sz))
        out[f"pos_peer_{d}{m}"] = pos_p
        buf = np.full((p_sz, cap_p), -1, np.int32)
        keep = pos_p < cap_p
        buf[peer[keep], pos_p[keep]] = (flat % e_loc)[keep]
        send_e[d, m] = buf
for d in range(2):
    for m in range(4):
        r_e = np.concatenate([send_e[d, s][m] for s in range(4)])
        valid = r_e >= 0
        r_e_c = np.where(valid, r_e, 0)
        out[f"pos_owner_{d}{m}"] = np.asarray(jmoe.positions_within(
            jnp.asarray(np.where(valid, r_e_c, e_loc)), e_loc + 1))

# ---- the vocab-parallel loss, f32, (data 2, model 2)
mesh2 = make_mesh((2, 2), ("data", "model"))
q = get_smoke_config("qwen2-7b").replace(dtype="float32")
xh = rng.normal(size=(4, 15, q.d_model)).astype(np.float32)
w = (rng.normal(size=(q.d_model, q.vocab_size)) * 0.1).astype(np.float32)
lab = rng.integers(0, q.vocab_size, (4, 15)).astype(np.int32)
out["vp_x"], out["vp_w"], out["vp_labels"] = xh, w, lab
def vp(xx, ww, ll):
    with shd.use_mesh(mesh2):
        return jtfm.vocab_parallel_cross_entropy(xx, {}, {"w": ww}, q, ll,
                                                 mesh2)
out["vp_loss"] = np.asarray(jax.jit(vp)(jnp.asarray(xh), jnp.asarray(w),
                                        jnp.asarray(lab)))
out["dense_loss"] = np.asarray(jtfm.cross_entropy(
    jnp.asarray(xh) @ jnp.asarray(w), jnp.asarray(lab)))

# ---- split-KV decode, qwen2-7b smoke f32, (data 2, model 2)
api = build_model(q)
qp = api.init(jax.random.key(3))
save_tree("qwen/", qp)
dt = rng.integers(0, q.vocab_size, (4, 16)).astype(np.int32)
out["dec_tokens"] = dt
def pre(p, t):
    with shd.use_mesh(mesh2):
        return api.prefill(p, {"tokens": t}, mesh2, pad_cache_to=16)
def dec(p, st, t):
    with shd.use_mesh(mesh2):
        return api.decode_step(p, st, t, mesh2)
lg, st = jax.jit(pre)(qp, jnp.asarray(dt[:, :12]))
out["dec_0"] = np.asarray(lg)
step = jax.jit(dec)
for i in range(3):
    lg, st = step(qp, st, jnp.asarray(dt[:, 12 + i]))
    out[f"dec_{i + 1}"] = np.asarray(lg)
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh") / "models.npz")
    return run_jax(JAX_CODE, path)


def _tree(ref, prefix):
    """The JAX params saved under ``prefix`` (float32, exact for bf16
    leaves) as the port's tree."""
    out = {}
    for key, arr in ref.items():
        if not key.startswith(prefix):
            continue
        node, parts = out, key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = convert.lm_params_from_numpy(arr, device="cpu")
    return _lists(out)


def _lists(tree):
    """Dicts keyed 0..n-1 as lists (a layer list's)."""
    if not isinstance(tree, dict):
        return tree
    tree = {k: _lists(v) for k, v in tree.items()}
    if tree and all(k.isdigit() for k in tree):
        return [tree[str(i)] for i in range(len(tree))]
    return tree


def _arctic(strategy, **kw):
    cfg = tget("arctic-480b").replace(scan_layers=True, **kw)
    return cfg.replace(parallel=cfg.parallel.replace(moe_strategy=strategy))


def _cast(tree, like):
    """``tree``'s leaves in the dtypes of ``like``'s (the port's init)."""
    if isinstance(tree, dict):
        return {k: _cast(tree[k], like[k]) for k in tree}
    if isinstance(tree, list):
        return [_cast(a, b) for a, b in zip(tree, like)]
    return tree.to(like.dtype)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_moe_strategy_loss_equals_jax(ref, strategy):
    cfg = _arctic(strategy, capacity_factor=4.0)
    api = build_model(cfg)
    params = _cast(_tree(ref, "arctic/"),
                   api.init(0, device="meta"))
    mesh = make_mesh((2, 4), ("data", "model"))
    sp = shd.shard_params(params, mesh, copy=False)
    toks = {"tokens": torch.from_numpy(ref["arctic_tokens"])}
    got = mesh.run(lambda c: api.loss(shd.local_tree(sp, c.rank), toks, c))
    for loss, _ in got:
        assert abs(float(loss) - float(ref["loss_" + strategy])) <= 2e-3, \
            (float(loss), float(ref["loss_" + strategy]))


class _Record:
    """Each rank thread's calls of ``topk_routing`` and
    ``positions_within`` inside ``moe``, in order."""

    def __init__(self, monkeypatch):
        import threading
        self.calls = {}
        real_top, real_pos = tmoe.topk_routing, tmoe.positions_within

        def top(*a):
            out = real_top(*a)
            self._add(threading.current_thread().name, ("ids", out[1]))
            return out

        def pos(ids, n):
            out = real_pos(ids, n)
            self._add(threading.current_thread().name, ("pos", out))
            return out
        monkeypatch.setattr(tmoe, "topk_routing", top)
        monkeypatch.setattr(tmoe, "positions_within", pos)

    def _add(self, who, item):
        self.calls.setdefault(who, []).append(item)


@pytest.mark.parametrize("strategy", ["move_compute", "move_data"])
def test_moe_routing_bit_equal_f32(ref, strategy, monkeypatch):
    cfg = _arctic(strategy, dtype="float32", capacity_factor=1.25)
    p = _tree(ref, "moe/")
    mesh = make_mesh((2, 4), ("data", "model"))
    sp = shd.shard_params(p, mesh)
    x = torch.from_numpy(ref["moe_x"])
    rec = _Record(monkeypatch)

    def body(c):
        xx = shd.constrain(x, ("batch", None, None), c)
        return tmoe.apply_moe(shd.local_tree(sp, c.rank), cfg, xx, mesh=c)
    got = mesh.run(body)
    y = torch.cat([got[0][0], got[4][0]], 0)          # data 0 and data 1
    np.testing.assert_allclose(y.numpy(), ref["moe_y_" + strategy],
                               rtol=F32_TOL, atol=F32_TOL)
    for _, aux in got:
        np.testing.assert_allclose(float(aux), ref["moe_aux_" + strategy],
                                   rtol=F32_TOL)
    for r in range(8):
        d, m = divmod(r, 4)
        calls = rec.calls[f"repro-rank-{r}"]
        ids = calls[0][1].reshape(-1).numpy()
        np.testing.assert_array_equal(ids, ref[f"ids_{d}{m}"])
        if strategy == "move_data":
            np.testing.assert_array_equal(calls[1][1].numpy(),
                                          ref[f"pos_local_{d}{m}"])
        else:
            np.testing.assert_array_equal(calls[1][1].numpy(),
                                          ref[f"pos_peer_{d}{m}"])
            np.testing.assert_array_equal(calls[2][1].numpy(),
                                          ref[f"pos_owner_{d}{m}"])


@pytest.mark.parametrize("threshold", [None, 0])
def test_vocab_parallel_cross_entropy_equals_jax(ref, threshold,
                                                 monkeypatch):
    if threshold is not None:
        monkeypatch.setattr(shd, "_REPLICATE_BELOW", threshold)
    cfg = tget("qwen2-7b").replace(dtype="float32")
    mesh = make_mesh((2, 2), ("data", "model"))
    head = shd.shard_params({"w": torch.from_numpy(ref["vp_w"])}, mesh)
    x, lab = torch.from_numpy(ref["vp_x"]), torch.from_numpy(ref["vp_labels"])

    def body(c):
        with shd.use_mesh(c):
            return ttfm.vocab_parallel_cross_entropy(
                shd.constrain(x, ("batch", None, None), c), {},
                shd.local_tree(head, c.rank), cfg,
                shd.constrain(lab, ("batch", None), c), c)
    for loss in mesh.run(body):
        np.testing.assert_allclose(float(loss), ref["vp_loss"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(float(loss), ref["dense_loss"], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("threshold", [None, 0])
def test_split_kv_decode_equals_jax(ref, threshold, monkeypatch):
    if threshold is not None:
        monkeypatch.setattr(shd, "_REPLICATE_BELOW", threshold)
    cfg = tget("qwen2-7b").replace(dtype="float32")
    api = build_model(cfg)
    params = _tree(ref, "qwen/")
    mesh = make_mesh((2, 2), ("data", "model"))
    sp = shd.shard_params(params, mesh)
    toks = torch.from_numpy(ref["dec_tokens"])

    def body(c):
        with shd.use_mesh(c), torch.no_grad():
            p = shd.local_tree(sp, c.rank)
            if threshold == 0:
                assert ttfm.heads_split(ttfm.layer_params(p, 0)["attn"], cfg,
                                        c)
            lg, st = api.prefill(p, {"tokens": toks[:, :12]}, c,
                                 pad_cache_to=16)
            assert st["layers"][0]["k"].shape == (2, 2, 8, 16)
            out = [lg]
            for i in range(3):
                lg, st = api.decode_step(p, st, toks[:, 12 + i], c)
                out.append(lg)
            return out
    for outs in mesh.run(body):
        for i, lg in enumerate(outs):
            np.testing.assert_allclose(lg.numpy(), ref[f"dec_{i}"],
                                       rtol=F32_TOL, atol=F32_TOL)
