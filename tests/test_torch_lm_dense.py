"""The dense family at ``SMOKE_CONFIG`` (qwen2-7b, qwen3-14b,
starcoder2-15b, chatglm3-6b): the port's prefill and decode logits, a
decode step from JAX's prefill state carried across, and the loss against
the JAX package's, from JAX's params carried across
(``tests/_torch_lm.py``: 2e-3 in float32, as JAX's own test; eight bf16
ulps at the logits' scale in bf16)."""
import numpy as np
import pytest

from _torch_lm import assert_logits_close, f32, serve_both

ARCHS = ("qwen2-7b", "qwen3-14b", "starcoder2-15b", "chatglm3-6b")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_loss_match_jax(arch, dtype):
    out = serve_both(arch, dtype)
    assert_logits_close(*out["prefill"], dtype, f"{arch} prefill")
    for i, (got, want) in enumerate(out["decode"]):
        assert_logits_close(got, want, dtype, f"{arch} decode step {i}")
    assert_logits_close(*out["injected"], dtype,
                        f"{arch} decode from the JAX state")
    got, want = (float(f32(x)) for x in out["loss"])
    assert abs(got - want) <= (2e-5 if dtype == "float32" else 2e-3) * want
