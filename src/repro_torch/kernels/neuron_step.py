"""K8: the fused per-neuron state update — two half-ms Izhikevich Euler
halves, the spike reset, calcium, and synaptic-element growth in one pass.

``neuron_step_plain`` is ``core/neuron.py::update_activity`` followed by
``update_elements`` without a lesion, the math of the JAX package's
``kernels/neuron_step.py::_integrate`` in its order of operations.
``neuron_step`` is the wrapper of the hand-written CUDA kernel
``csrc/neuron_step.cu``: on a CUDA tensor it launches the kernel or raises;
on a CPU tensor it runs the plain version.

Two variants, as in JAX: with every one of a, b, c, d, nu and eps a scalar
the constants are kernel arguments; with any of them an array, all six are
broadcast to per-neuron (n,) arrays. The calcium decay and beta are always
scalars. Any n >= 1 works (the TPU kernel's padding to a block is its own
detail).
"""
from __future__ import annotations

import torch

from repro_torch.core import neuron
from repro_torch.kernels import _build

launches = _build.LaunchCounter("neuron_step")


def _constants(cfg, params):
    p = neuron.params_from_config(cfg) if params is None else params
    return (p.izh_a, p.izh_b, p.izh_c, p.izh_d, p.growth_rate,
            p.target_calcium)


def _is_scalar(x) -> bool:
    return not isinstance(x, torch.Tensor) or x.dim() == 0


def neuron_step_plain(v, u, ca, ax, de, inp, cfg, *, params=None):
    """All inputs (n,) f32; ``params`` an optional ``NeuronParams`` (scalar
    or (n,) entries). Returns (v, u, ca, ax, de, spiked)."""
    st = neuron.NeuronState(v, u, ca, ax, de, spiked=None,
                            spike_count=torch.zeros((), device=v.device),
                            rate=None, is_excitatory=None)
    st = neuron.update_elements(
        neuron.update_activity(st, inp, None, cfg, params), cfg, params)
    return (st.v, st.u, st.calcium, st.ax_elements, st.de_elements,
            st.spiked)


def neuron_step(v, u, ca, ax, de, inp, cfg, *, params=None):
    """One fused step of n neurons (K8). All state inputs (n,) f32.
    Returns (v, u, ca, ax, de, spiked (n,) bool)."""
    if v.device.type != "cuda":
        return neuron_step_plain(v, u, ca, ax, de, inp, cfg, params=params)
    n = v.shape[0]
    dev = v.device
    f32 = torch.float32
    state = [x.to(f32).contiguous() for x in (v, u, ca, ax, de, inp)]
    if any(x.shape != (n,) for x in state):
        raise ValueError("neuron_step: v, u, ca, ax, de, inp must all be (n,)")
    consts = _constants(cfg, params)
    hetero = not all(_is_scalar(x) for x in consts)
    if hetero:
        arrays = [torch.broadcast_to(torch.as_tensor(x, dtype=f32, device=dev),
                                     (n,)).contiguous() for x in consts]
        scalars = [0.0] * 6
    else:
        arrays = [torch.empty(0, dtype=f32, device=dev)] * 6
        scalars = [float(x) for x in consts]
    outs = [torch.empty(n, dtype=f32, device=dev) for _ in range(5)]
    spiked = torch.empty(n, dtype=torch.bool, device=dev)
    _build.require_cuda("neuron_step", *state, *arrays, *outs, spiked)
    lib = _build.library()
    _build.check(lib.repro_neuron_step(
        *(t.data_ptr() for t in state + arrays + outs), spiked.data_ptr(),
        n, int(hetero), *scalars, float(cfg.calcium_decay),
        float(cfg.calcium_beta), _build.stream()), "neuron_step")
    launches.add()
    return (*outs, spiked)
