"""K8: the fused per-neuron state update — two half-ms Izhikevich Euler
halves, the spike reset, calcium, and synaptic-element growth in one pass.

``neuron_step_plain`` is ``core/neuron.py::update_activity`` followed by
``update_elements`` without a lesion, the math of the JAX package's
``kernels/neuron_step.py::_integrate`` in its order of operations.
``neuron_step`` is the wrapper of the hand-written CUDA kernel
``csrc/neuron_step.cu``: on a CUDA tensor it launches the kernel or raises;
on a CPU tensor it runs the plain version.

Each of a, b, c, d, nu and eps is a Python number, a one-element tensor or
an (n,) tensor, in any mix (the JAX kernel's two variants are the all-scalar
and the all-array cases); the kernel reads each where it lies (stride 0 or
1), so an f32 parameter on the card is neither broadcast nor copied. The
calcium decay and beta are always scalars. Any n >= 1 works (the TPU
kernel's padding to a block is its own detail).

The wrapper does per call only its checks, the packing of the parameters
(from ``cfg``'s fields or from ``params``, read anew on every call, so a
change made to them in place is seen; nothing is kept between calls), one
allocation and one launch: the five f32 outputs and ``spiked`` are views of
one buffer (each at a 16-byte boundary), and the C entry takes one packed
struct.
"""
from __future__ import annotations

import struct

import torch

from repro_torch.core import neuron
from repro_torch.kernels import _build

launches = _build.LaunchCounter("neuron_step")


# csrc/neuron_step.cu NeuronStepArgs as bytes (208, no padding): in[6],
# out[5] and spiked (pointers), then the tail packed from the parameters:
# param[6] (pointers), stride[6] (int), value[6], ca_decay, ca_beta
# (float), then n and vec (int; vec is set by the C entry)
_TAIL = struct.Struct("=6Q6i8f")
_ARGS = struct.Struct(f"=12Q{_TAIL.size}s2i")
_NO_ARRAYS = (0,) * 12          # param[6] and stride[6] when all are values


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


def _tail(cfg, params, index: int, keep: list):
    """The constant part of the kernel's parameters, packed from ``cfg``
    (``params`` None) or from ``params`` on every call, so a change made to
    either is seen. A parameter is a number (by value), an f32 tensor on
    the card ``index`` (read where it lies: stride 0 for one value, 1 for
    an (n,) array) or anything else (copied to such a tensor, held in
    ``keep`` until the launch is queued). Returns (the packed tail, the
    (n,) length the arrays need or None)."""
    if params is None:
        return _TAIL.pack(*_NO_ARRAYS, float(cfg.izh_a), float(cfg.izh_b),
                          float(cfg.izh_c), float(cfg.izh_d),
                          float(cfg.element_growth_rate),
                          float(cfg.target_calcium),
                          float(cfg.calcium_decay),
                          float(cfg.calcium_beta)), None
    ptrs, strides, values = [0] * 6, [0] * 6, [0.0] * 6
    length = None
    for k, x in enumerate((params.izh_a, params.izh_b, params.izh_c,
                           params.izh_d, params.growth_rate,
                           params.target_calcium)):
        if not isinstance(x, torch.Tensor):
            if getattr(x, "ndim", 0) == 0:
                values[k] = float(x)
                continue
            x = torch.as_tensor(x)
        if x.dtype is not torch.float32 or x.get_device() != index:
            x = x.to(device=torch.device("cuda", index), dtype=torch.float32)
            keep.append(x)
        shape = x.shape
        if len(shape) == 1 and shape[0] != 1:
            if length not in (None, shape[0]):
                raise ValueError("neuron_step: (n,) parameters of two n")
            if x.stride(0) != 1:
                x = x.contiguous()
                keep.append(x)
            strides[k], length = 1, shape[0]
        elif x.numel() != 1:
            raise ValueError("neuron_step: a parameter is a number, one "
                             "value or one (n,) array")
        ptrs[k] = x.data_ptr()
    return _TAIL.pack(*ptrs, *strides, *values, float(cfg.calcium_decay),
                      float(cfg.calcium_beta)), length


def _inputs(state, index: int):
    """The six (n,) f32 state inputs on the card ``index``, made contiguous
    where they are not; another dtype, device or shape raises."""
    shape = state[0].shape
    if len(shape) != 1:
        raise ValueError("neuron_step: the state is (n,)")
    out = []
    for x in state:
        if x.dtype is not torch.float32:
            raise TypeError(f"neuron_step: f32 inputs only, got {x.dtype}")
        if x.shape != shape or x.get_device() != index:
            raise ValueError("neuron_step: v, u, ca, ax, de, inp must all be "
                             "(n,) on one CUDA device")
        out.append(x if x.is_contiguous() else x.contiguous())
    return out, shape[0]


def _outputs(n: int, dev: torch.device):
    """One allocation carved into the five (n,) f32 outputs and the (n,)
    bool ``spiked``, each at a 16-byte boundary. Returns (outputs, address
    of the first, stride between them in bytes)."""
    n4 = (n + 3) & ~3
    buf = torch.empty(5 * n4 + n4 // 4, dtype=torch.float32, device=dev)
    parts = buf.split_with_sizes((n4,) * 5 + (n4 // 4,))
    outs, spiked = parts[:5], parts[5].view(torch.bool)
    if n4 != n:
        outs, spiked = tuple(x[:n] for x in outs), spiked[:n]
    return (*outs, spiked), buf.data_ptr(), 4 * n4


def _launch(tail: bytes, ins, n: int, base: int, step: int, index: int,
            floor: bool = False) -> None:
    args = _ARGS.pack(*(x.data_ptr() for x in ins), base, base + step,
                      base + 2 * step, base + 3 * step, base + 4 * step,
                      base + 5 * step, tail, n, 0)
    lib = _build.library()
    fn = lib.repro_neuron_step_floor if floor else lib.repro_neuron_step
    _build.check(fn(args, _build.stream(index)), "neuron_step")


def _operands(state, cfg, params):
    """Checks, the packed tail and one output allocation for a call:
    (card index, inputs, n, tail, outputs, output base, output stride,
    tensors to hold until the launch is queued)."""
    index = state[0].get_device()
    ins, n = _inputs(state, index)
    keep = []
    tail, length = _tail(cfg, params, index, keep)
    if length not in (None, n):
        raise ValueError(f"neuron_step: (n,) parameters of {length} "
                         f"neurons for {n}")
    outs, base, step = _outputs(n, ins[0].device)
    return index, ins, n, tail, outs, base, step, keep


def neuron_step(v, u, ca, ax, de, inp, cfg, *, params=None):
    """One fused step of n neurons (K8). All state inputs (n,) f32.
    Returns (v, u, ca, ax, de, spiked (n,) bool)."""
    if not v.is_cuda:
        return neuron_step_plain(v, u, ca, ax, de, inp, cfg, params=params)
    index, ins, n, tail, outs, base, step, keep = _operands(
        (v, u, ca, ax, de, inp), cfg, params)
    if n:
        _launch(tail, ins, n, base, step, index)
        launches.add()
    return outs


def floor_launch(v, u, ca, ax, de, inp, cfg, *, params=None) -> None:
    """Launch the empty kernel of the grid ``neuron_step`` launches for
    these operands (its time is the floor under K8's; not counted)."""
    index, ins, n, tail, outs, base, step, keep = _operands(
        (v, u, ca, ax, de, inp), cfg, params)
    _launch(tail, ins, n, base, step, index, floor=True)
