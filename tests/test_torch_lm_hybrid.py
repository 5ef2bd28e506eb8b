"""The vlm and hybrid families at ``SMOKE_CONFIG`` (llava-next-34b with
its patch embeddings, recurrentgemma-2b with RG-LRU blocks and a ring
window of 16 that a 20-token prompt passes), and the stacked layout
(``layers_stacked``, which no smoke config uses: qwen2-7b with
``scan_layers``, full and with a ring window of 8), against the JAX
package: prefill and decode logits, a decode step from JAX's prefill
state, loss and decode state, tolerances as in
``tests/_torch_lm.py``."""
import numpy as np
import pytest

from _torch_lm import assert_logits_close, f32, serve_both

CASES = {
    "llava-next-34b": dict(arch="llava-next-34b"),
    "recurrentgemma-2b": dict(arch="recurrentgemma-2b", prompt=20, steps=4),
    "qwen2-7b-stacked": dict(arch="qwen2-7b", scan_layers=True),
    "qwen2-7b-stacked-window": dict(arch="qwen2-7b", scan_layers=True,
                                    attn_window=8, prompt=11, steps=4),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_decode_and_loss_match_jax(case, dtype):
    kw = dict(CASES[case])
    arch = kw.pop("arch")
    out = serve_both(arch, dtype, **kw)
    assert_logits_close(*out["prefill"], dtype, f"{case} prefill")
    for i, (got, want) in enumerate(out["decode"]):
        assert_logits_close(got, want, dtype, f"{case} decode step {i}")
    assert_logits_close(*out["injected"], dtype,
                        f"{case} decode from the JAX state")
    got, want = (float(f32(x)) for x in out["loss"])
    assert abs(got - want) <= (2e-5 if dtype == "float32" else 2e-3) * want
    if dtype == "float32":            # the caches and recurrent states
        ts, js = out["state"]
        assert int(ts["pos"]) == int(js["pos"])
        tl, jl = ts["layers"], js["layers"]
        pairs = [(tl[k], jl[k]) for k in tl] if isinstance(tl, dict) else \
            [(t[k], j[k]) for t, j in zip(tl, jl) for k in t]
        for t, j in pairs:
            assert tuple(t.shape) == tuple(j.shape)
            np.testing.assert_allclose(f32(t), f32(j), rtol=2e-3, atol=2e-3)
