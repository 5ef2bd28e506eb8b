"""The port's training loss and gradients against the JAX package's.

One f32 smoke model of each family (the dense and vlm ones here, the
others in ``test_torch_train_families.py``), JAX's init carried across
(``convert.lm_params_from_numpy``), the same numpy tokens: the port's loss
and ``backward()`` (``launch.steps.loss_and_grads``) against
``jax.value_and_grad(api.loss)`` under ``jit``. The loss within 2e-3
absolute and relative (the LM tests' f32 tolerance), each leaf's gradient
within 2e-3 of the leaf's largest |gradient| (a leaf's small entries are
sums that cancel). qwen2-7b runs in both layouts: ``scan_layers`` True
holds the stacked tree split once per forward (``transformer.unstack``).
``_remat`` in its three modes gives 'none''s loss and gradients."""
import pytest

from _torch_train import both, check_loss_and_grads
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import build_model as tbuild
from repro_torch.optim.optimizer import leaves

CASES = [("qwen2-7b", {"scan_layers": False}),
         ("qwen2-7b", {"scan_layers": True}), ("llava-next-34b", {})]


@pytest.mark.parametrize("arch,kw", CASES)
def test_loss_and_grads_match_jax(arch, kw):
    check_loss_and_grads(arch, kw)


@pytest.mark.parametrize("mode", ["full", "dots_saveable"])
@pytest.mark.parametrize("scan", [False, True])
def test_remat_modes_give_the_same_grads(mode, scan):
    """'full' and 'dots_saveable' (non-reentrant checkpoint, the latter
    keeping the matrix products) against 'none' on the same params: the
    same loss, and the same gradients within 1e-6 of each leaf's scale
    (the recomputed forward is the same arithmetic)."""
    import dataclasses
    _, tapi, _, tp, _, tb = both("qwen2-7b", scan_layers=scan)
    cfg = tapi.cfg

    def run(remat):
        c = cfg.replace(parallel=dataclasses.replace(cfg.parallel,
                                                     remat=remat))
        params = {k: v for k, v in tp.items()}
        return loss_and_grads(tbuild(c), params, tb)
    l0, _, g0 = run("none")
    l1, _, g1 = run(mode)
    assert float(l1) == float(l0)
    for a, b in zip(leaves(g1), leaves(g0)):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-6 * scale + 1e-30
