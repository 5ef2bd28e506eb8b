"""The LM serve driver (``repro_torch.launch.serve_lm``) against the JAX
package's ``examples/serve_lm.py``: the example runs as it is (its
``jnp`` wrapped so that the test reads every argmax's logits and the
stacked tokens), and the port serves the same arch from the example's own
params (``api.init(jax.random.key(0))``, carried across) and prompt
(``jax.random.randint(jax.random.key(1), ...)``), on the CPU in bf16.

Greedy tokens must be equal; where a row's tokens first differ, the
example's logits there must be a near-tie (top-2 gap under the bf16 logits
tolerance of ``tests/_torch_lm.py``), which ends that row's comparison.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import bf16_tol, greedy_agreement
from repro.configs import get_smoke_config as jget
from repro.models import build_model as jbuild
from repro_torch import convert
from repro_torch.launch import serve_lm

ROOT = pathlib.Path(__file__).resolve().parents[1]


class _Recorder:
    """``jax.numpy`` with argmax and stack recorded."""

    def __init__(self):
        self.logits, self.tokens = [], None

    def __getattr__(self, name):
        return getattr(jnp, name)

    def argmax(self, x, axis):
        self.logits.append(np.asarray(x, np.float32))
        return jnp.argmax(x, axis)

    def stack(self, xs, axis):
        out = jnp.stack(xs, axis)
        self.tokens = np.asarray(out)
        return out


@pytest.fixture(scope="module")
def example():
    spec = importlib.util.spec_from_file_location(
        "serve_lm_example", ROOT / "examples" / "serve_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["qwen3-14b", "recurrentgemma-2b"])
def test_serve_matches_the_example(arch, example, monkeypatch, capsys):
    rec = _Recorder()
    monkeypatch.setattr(example, "jnp", rec)
    example.serve(arch)
    line = capsys.readouterr().out
    cfg = jget(arch)
    params = jbuild(cfg).init(jax.random.key(0))
    prompt = jax.random.randint(jax.random.key(1), (4, 24), 0,
                                cfg.vocab_size)
    toks = serve_lm.serve(
        arch, device="cpu",
        params=convert.lm_params_from_numpy(jax.device_get(params),
                                            device="cpu"),
        batch={"tokens": torch.from_numpy(np.array(prompt))})
    out = capsys.readouterr().out
    assert toks.shape == (4, 12) and rec.tokens.shape == (4, 12)
    assert f"sample={rec.tokens[0, :6].tolist()}" in line
    ties, compared = greedy_agreement(toks.numpy(), rec.tokens, rec.logits,
                                      bf16_tol(rec.logits[0]))
    # bf16 logits of the smoke vocab (512) tie often: one ulp is 2**-6 at
    # |logit| 2-4; the example's recurrentgemma-2b rows have top-2 gaps of
    # 0 to 3 ulps where they part. Half the decisions must be compared.
    assert compared >= toks.numel() // 2, (ties, compared)
    if (toks[0, :6].numpy() == rec.tokens[0, :6]).all():
        assert f"sample={rec.tokens[0, :6].tolist()}" in out


def test_main_serves_the_ported_archs_and_names_the_rest(capsys):
    assert serve_lm.main(["--device", "cpu", "--batch", "2", "--prompt",
                          "8", "--gen", "3"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [x.split()[0] for x in lines] == list(serve_lm.EXAMPLE_ARCHS)
    assert "2x8+3" in lines[0] and "2x8+3" in lines[1]
    assert "item 14c" in lines[2] and "item 14d" in lines[3]
