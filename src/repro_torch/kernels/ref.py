"""Plain torch oracles for every kernel of the public API, under the JAX
package's ``kernels/ref.py`` names: the plain versions beside the kernels."""
from __future__ import annotations

from repro_torch.kernels.activity_fused import window_plain
from repro_torch.kernels.bh_gauss import bh_gauss_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.neuron_step import neuron_step_plain

attention_ref = flash_attention_plain
bh_gauss_ref = bh_gauss_plain
activity_window_ref = window_plain


def neuron_step_ref(v, u, ca, ax, de, inp, cfg, params=None):
    """``core/neuron.py::update_activity`` + ``update_elements`` (no lesion)
    in one pass; ``params`` (NeuronParams, scalar or per-neuron) overrides
    the config's constants."""
    return neuron_step_plain(v, u, ca, ax, de, inp, cfg, params=params)
