"""Shared helpers of the training tests: one f32 smoke model through the
JAX package and the port, JAX's init carried across
(``convert.lm_params_from_numpy``), the same numpy tokens."""
import jax
import numpy as np

from _torch_lm import F32_TOL, configs, inputs, jax_batch, torch_batch
from repro.models import build_model as jbuild
from repro_torch import convert
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import build_model as tbuild
from repro_torch.optim.optimizer import leaves


def both(arch, batch=2, seq=16, **kw):
    jcfg, tcfg = configs(arch, dtype="float32", **kw)
    japi, tapi = jbuild(jcfg), tbuild(tcfg)
    jp = jax.jit(japi.init)(jax.random.key(0))
    tp = convert.lm_params_from_numpy(jax.device_get(jp), device="cpu")
    arr = inputs(jcfg, batch, seq, seed=1)
    return japi, tapi, jp, tp, jax_batch(arr, jcfg), torch_batch(arr, tcfg)


def assert_grads_close(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.detach().float().numpy()
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, (what, i)
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= F32_TOL * scale + 1e-30, (what, i, err, scale)


def check_loss_and_grads(arch, kw):
    japi, tapi, jp, tp, jb, tb = both(arch, **kw)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: japi.loss(p, jb), has_aux=True))(jp)
    loss, metrics, grads = loss_and_grads(tapi, tp, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(float(metrics["aux"]), float(jm["aux"]),
                               rtol=F32_TOL, atol=F32_TOL)
    if arch == "moonshot-v1-16b-a3b":
        assert float(metrics["aux"]) > 0       # the load-balance term
    assert all(p.grad is None for p in leaves(tp))
    assert_grads_close(leaves(grads), jax.tree.leaves(jg), arch)
