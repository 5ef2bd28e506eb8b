"""The LM stack's configs, specs, init and serving invariants.

Against the JAX package: every architecture's ``param_count``,
``active_param_count`` and ``input_specs`` at the full config (the port's
specs are ``meta`` tensors, nothing allocated); the served families' param
and decode-state trees at the full config on ``meta`` (keys, shapes,
dtypes), and the init at ``SMOKE_CONFIG`` (the same tree, zeros and ones
where JAX has them, each drawn leaf's spread within 25 % of JAX's: the two
generators differ, and a leaf of 512 draws estimates its spread within
about 6 %). Inside the port: prefill + decode logits equal the full
forward's at the same positions (2e-3 in float32, JAX's own test; eight
bf16 ulps at the logits' scale in bf16), through a ring window that the
prompt and the decode pass, for every family (the MoE at JAX's ample
capacity). The MoE's sharded strategies raise naming their item.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_lm import SERVED, F32_TOL, bf16_tol, configs, inputs, \
    torch_batch
from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs.base import SHAPES as SHAPES_J
from repro.configs.base import applicable_shapes as japplicable
from repro.configs.base import supports_long_context as jlong
from repro.models import build_model as jbuild
from repro.models import model as jmodel
from repro_torch import convert
from repro_torch.configs import (ARCH_IDS, SHAPES, applicable_shapes,
                                 get_config, get_shape, supports_long_context)
from repro_torch.configs import get_smoke_config as tget
from repro_torch.models import build_model, model as tmodel
from repro_torch.models import decode as tdecode
from repro_torch.models import encdec as tencdec
from repro_torch.models import transformer as ttfm


def _flat(tree, prefix=""):
    """{'a/b/0/c': leaf} for nested dicts and lists (JAX's tree order is by
    sorted key; compared as dicts)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _dt(x):
    return str(x.dtype).replace("torch.", "")


def test_registry_matches_the_reference():
    assert ARCH_IDS == JARCH_IDS
    assert {k: (v.seq_len, v.global_batch, v.kind)
            for k, v in SHAPES.items()} == {
        k: (v.seq_len, v.global_batch, v.kind) for k, v in SHAPES_J.items()}
    assert get_shape("decode_32k").seq_len == 32_768
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")


@pytest.mark.parametrize("arch", JARCH_IDS)
def test_counts_and_input_specs_equal_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.pattern() == jcfg.pattern()
    assert supports_long_context(cfg) == jlong(jcfg)
    shapes = applicable_shapes(cfg)
    assert [s.name for s in shapes] == [s.name for s in japplicable(jcfg)]
    for shape in shapes:
        got = tmodel.input_specs(cfg, shape)
        want = jmodel.input_specs(jcfg, SHAPES_J[shape.name])
        assert sorted(got) == sorted(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == want[k].shape
            assert _dt(t) == str(want[k].dtype)


@pytest.mark.parametrize("arch", SERVED)
def test_param_and_state_specs_equal_jax_on_meta(arch):
    """The full config's param tree and decode state (decode_32k: batch
    128, 32,768 positions) as meta tensors: JAX's keys, shapes, dtypes."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    got = _flat(tmodel.param_specs(cfg))
    want = _flat(jmodel.param_specs(jcfg))
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert t.device.type == "meta", k
        assert (tuple(t.shape), _dt(t)) == (want[k].shape,
                                            str(want[k].dtype)), k
    shape = get_shape("decode_32k")
    got = _flat(tmodel.decode_state_specs(cfg, shape))
    want = _flat(jmodel.decode_state_specs(jcfg, SHAPES_J["decode_32k"]))
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert (tuple(t.shape), _dt(t)) == (want[k].shape,
                                            str(want[k].dtype)), k


@pytest.mark.parametrize("arch", SERVED)
def test_init_matches_jax_tree_and_scales(arch):
    jcfg, cfg = configs(arch)
    want = _flat(jax.device_get(jbuild(jcfg).init(jax.random.key(0))))
    got = _flat(build_model(cfg).init(0, device="cpu"))
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        w = np.asarray(want[k], np.float32)
        assert (tuple(t.shape), _dt(t)) == (w.shape, str(want[k].dtype)), k
        g = t.float().numpy()
        if not w.std():                       # zeros and ones
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif k.endswith("lambda"):            # decay in [0.9, 0.999] at r=1
            assert g.min() >= w.min() - 0.1 and g.max() <= w.max() + 0.1, k
        else:
            assert 0.8 < g.std() / w.std() < 1.25, (k, g.std(), w.std())
            assert abs(g.mean()) < 4 * w.std() / np.sqrt(w.size), k
    # a seed gives the same params twice, another seed others
    again = _flat(build_model(cfg).init(0, device="cpu"))
    other = _flat(build_model(cfg).init(1, device="cpu"))
    k = "embed/table"
    assert torch.equal(got[k], again[k]) and not torch.equal(got[k], other[k])


# ample MoE capacity, as JAX's own test: capacity buckets quantise with the
# token count, so the prefill, the steps and the forward drop other slots
SELF_CASES = [(a, {"capacity_factor": 8.0} if "moe" in tget(a).family
               else {}) for a in SERVED] + [
    ("qwen2-7b", {"scan_layers": True, "attn_window": 8})]


def _forward(params, cfg, batch):
    if cfg.family == "audio":
        return tencdec.forward(params, cfg, batch["frames"], batch["tokens"])
    return ttfm.forward(params, cfg, batch["tokens"],
                        extra_embeds=batch.get("patch_embeds"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,kw", SELF_CASES,
                         ids=[a + ("-stacked-window" if "attn_window" in kw
                                   else "") for a, kw in SELF_CASES])
def test_prefill_and_decode_match_forward(arch, kw, dtype):
    """JAX's ``test_prefill_decode_match_forward`` inside the port, over 6
    decode steps: a 20-token prompt passes recurrentgemma's window of 16
    and the stacked variant's window of 8, so the ring is rolled at the
    prefill and wraps while decoding; the xLSTM states carry from the
    scans into the steps; whisper's decoder reads the encoded frames."""
    _, cfg = configs(arch, dtype=dtype, **kw)
    api = build_model(cfg)
    params = api.init(3, device="cpu")
    t, steps = 20, 6
    arr = inputs(cfg, 2, t + steps, seed=5)
    full = torch_batch(arr, cfg)
    logits, _ = _forward(params, cfg, full)
    n_extra = cfg.num_patches if cfg.family == "vlm" else 0
    p_logits, state = api.prefill(params, torch_batch(arr, cfg, t),
                                  pad_cache_to=n_extra + t + steps)
    got = [p_logits]
    for i in range(steps):
        d_logits, state = api.decode_step(params, state,
                                          full["tokens"][:, t + i])
        got.append(d_logits)
    assert int(state["pos"]) == n_extra + t + steps
    want = logits[:, n_extra + t - 1:]
    for i, g in enumerate(got):
        w = want[:, i].float().numpy()
        tol = F32_TOL if dtype == "float32" else bf16_tol(w)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=tol, atol=tol,
                                   err_msg=f"{arch} position {t - 1 + i}")


def test_decode_caches_are_written_in_place():
    """A decode step writes its k and v into the state's caches (no copy a
    step); a cloned state decodes to the same logits."""
    _, cfg = configs("qwen2-7b", dtype="float32", scan_layers=True)
    api = build_model(cfg)
    params = api.init(0, device="cpu")
    toks = torch.from_numpy(inputs(cfg, 2, 9, seed=1)["tokens"])
    _, state = api.prefill(params, {"tokens": toks[:, :8]}, pad_cache_to=12)
    before = state["layers"]["k"]
    kept = {"pos": state["pos"].clone(),
            "layers": {k: v.clone() for k, v in state["layers"].items()}}
    l1, s1 = api.decode_step(params, state, toks[:, 8])
    assert s1["layers"]["k"] is before and int(s1["pos"]) == 9
    assert not torch.equal(before, kept["layers"]["k"])
    l2, _ = api.decode_step(params, kept, toks[:, 8])
    assert torch.equal(l1, l2)


@pytest.mark.parametrize("pos,slot", [(3, 3), (11, 11), (12, 11), (40, 11)])
def test_full_cache_write_clamps_as_dynamic_update_slice(pos, slot):
    """JAX's ``dynamic_update_slice`` clamps its start into the cache: a
    position at or past the last slot writes the last slot."""
    _, cfg = configs("qwen2-7b", dtype="float32")
    p = ttfm.layer_params(build_model(cfg).init(0, device="cpu"), 0)
    cache = tdecode._attn_cache(cfg, 1, 12, "cpu")
    x = torch.randn(1, cfg.d_model, generator=torch.Generator().manual_seed(0))
    _, cache = tdecode.attn_block_decode(p, cfg, x, cache,
                                         torch.tensor(pos, dtype=torch.int32))
    written = (cache["k"] != 0).any(dim=(0, 1, 3))
    assert written.nonzero().flatten().tolist() == [slot]


def test_converters_round_trip_bf16_bits():
    _, cfg = configs("recurrentgemma-2b")
    params = build_model(cfg).init(0, device="cpu")
    tree = convert.lm_params_to_numpy(params)
    assert tree["embed"]["table"].dtype == np.uint16
    back = convert.lm_params_from_numpy(tree, device="cpu")
    flat, flat_back = _flat(params), _flat(back)
    assert all(torch.equal(flat[k], flat_back[k].view(flat[k].dtype))
               for k in flat)
    state = tdecode.init_decode_state(cfg, 2, 8, "cpu")
    st = convert.lm_state_from_numpy(convert.lm_params_to_numpy(state),
                                     device="cpu")
    assert st["pos"].dtype == torch.int32 and st["pos"].dim() == 0
    assert _flat(st).keys() == _flat(state).keys()


@pytest.mark.parametrize("strategy", ["move_data", "move_compute"])
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "arctic-480b"])
def test_moe_on_a_mesh_raises_naming_its_item(arch, strategy):
    """The moe family's sharded strategies (item 14f) run on a (1, 2)
    mesh: ``apply_moe`` under each gives the rank's rows and a positive
    aux, and the model's prefill, with a capacity that drops nothing, the
    mesh-free logits within F32_TOL (its aux, a mean over each rank's
    tokens, is no part of the logits)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as tmoe
    from repro_torch.parallel import sharding as shd
    _, cfg = configs(arch, dtype="float32", capacity_factor=8.0)
    cfg = cfg.replace(parallel=cfg.parallel.replace(moe_strategy=strategy))
    api = build_model(cfg)
    params = api.init(0, device="cpu")
    p = ttfm.layer_params(params, 0)["moe"]
    x = torch.randn((1, 4, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    mesh = make_mesh((1, 2), ("data", "model"))
    for y, aux in mesh.run(lambda c: tmoe.apply_moe(p, cfg, x, mesh=c)):
        assert y.shape == x.shape and float(aux) > 0.0
    toks = {"tokens": torch.arange(8, dtype=torch.int32).reshape(2, 4)}
    want, _ = api.prefill(params, toks)
    sp = shd.shard_params(params, mesh, copy=False)
    for got, _ in mesh.run(lambda c: api.prefill(shd.local_tree(sp, c.rank),
                                                 toks, c)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=F32_TOL,
                                   atol=F32_TOL)
    y, aux = tmoe.apply_moe(p, cfg, x)          # no mesh: moe_local
    assert y.shape == x.shape and float(aux) > 0.0


def test_a_mesh_raises_and_the_lowering_is_checked():
    _, cfg = configs("qwen2-7b", dtype="float32")
    api = build_model(cfg)
    params = api.init(0, device="cpu")
    toks = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sharding as shd
    mesh = make_mesh((1, 2), ("data", "model"))
    sp = shd.shard_params(params, mesh)
    for got, _ in mesh.run(lambda c: api.prefill(shd.local_tree(sp, c.rank),
                                                 toks, c)):
        np.testing.assert_allclose(got.numpy(), api.prefill(params, toks)[0]
                                   .numpy(), rtol=F32_TOL, atol=F32_TOL)
    with pytest.raises(ValueError, match="attention_impl"):
        cfg.replace(attention_impl="pallas")
    ref = build_model(cfg.replace(attention_impl="reference"))
    assert torch.equal(api.prefill(params, toks)[0],
                       ref.prefill(params, toks)[0])
