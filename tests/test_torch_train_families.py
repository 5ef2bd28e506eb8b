"""The port's training loss and gradients against the JAX package's for
the hybrid (RG-LRU), MoE (with its load-balance term), ssm (xLSTM) and
audio (encoder-decoder) families' f32 smoke models, as
``test_torch_train_grads.py`` holds the dense ones: the loss within 2e-3,
each leaf's gradient within 2e-3 of the leaf's largest |gradient|."""
import pytest

from _torch_train import check_loss_and_grads


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "moonshot-v1-16b-a3b",
                                  "xlstm-125m", "whisper-base"])
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch, {})
