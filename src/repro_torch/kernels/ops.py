"""The public kernel API: the JAX package's ``kernels/ops.py`` wrappers under
their names and keyword arguments, each the wrapper of a hand-written CUDA
kernel. There is no ``interpret`` argument: on CUDA tensors a wrapper
launches its kernel or raises, on CPU tensors it runs the plain version.

| wrapper | kernel | module |
|---|---|---|
| ``flash_attention(q, k, v, *, causal, window)`` | K9 | ``flash_attention`` |
| ``gauss_probs(x, y, w, *, sigma)`` | K7 | ``bh_gauss`` |
| ``fused_neuron_step(v, u, ca, ax, de, inp, cfg, *, params)`` | K8 | ``neuron_step`` |
| ``bh_traverse(...)`` | K2 | ``bh_traverse`` |
| ``radix_argsort(keys, *, key_bits)`` | K6 | ``radix_sort`` |
| ``morton_sort(positions, leaf_base, *, leaf_level, n_leaf)`` | K3 | ``radix_sort`` |
| ``synapse_apply(...)`` | K4 | ``synapse_apply`` |
| ``route_build(flat_other, flat_mine, *, n, num_ranks, cap)`` | K5 | ``synapse_apply`` |
| ``fused_activity_window(...)`` | K1 | ``activity_fused`` |

``fused_activity_window(..., rate_slots=...)`` takes the sparse exchange's
operand: the (subs_cap,) rate buffer read through the (n, S) slot remap.
"""
from __future__ import annotations

from repro_torch.kernels.activity_fused import \
    activity_window as fused_activity_window
from repro_torch.kernels.bh_gauss import bh_gauss_probs as gauss_probs
from repro_torch.kernels.bh_traverse import bh_traverse
from repro_torch.kernels.flash_attention import \
    flash_attention_fwd as flash_attention
from repro_torch.kernels.neuron_step import neuron_step as fused_neuron_step
from repro_torch.kernels.radix_sort import morton_sort, radix_argsort
from repro_torch.kernels.synapse_apply import route_build, synapse_apply

__all__ = ["flash_attention", "gauss_probs", "fused_neuron_step",
           "bh_traverse", "radix_argsort", "morton_sort", "synapse_apply",
           "route_build", "fused_activity_window"]
