"""K1: the activity window — Delta electrical steps of one rank.

``step_core`` is the exact per-step math of the JAX package's
``kernels/activity_fused.py::step_core`` on torch tensors; ``window_plain``
iterates it (the plain version, and the ``reference`` activity lowering).
``activity_window`` is the wrapper of the hand-written CUDA kernel
``csrc/activity_window.cu``: on a CUDA tensor it launches the kernel (one
cooperative launch per window, a grid barrier between steps) or raises; on a
CPU tensor it runs the plain version, as the JAX package's Pallas kernel runs
in interpret mode.

All randomness is the counter hash of ``kernels/hash.py`` keyed by
``(seed, domain, global step, neuron/edge id)``, so both versions draw the
same streams as the reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import hash as chash

launches = _build.LaunchCounter("activity_window")

# how the kernel held a block's rows, chosen in the C entry from the shape:
# staged in shared memory when they fit, streamed from global memory else
DEVICE_MODES = ("staged", "streaming")
# the return code of repro_activity_window that is not a CUDA error
_NO_COOPERATIVE_LAUNCH = -2


def device_launches(*, reset: bool = False) -> dict:
    """Device launches of K1 by mode since the last reset, as counted in
    ``csrc/activity_window.cu`` beside each launch; ``reset`` sets the counts
    to 0 after reading them."""
    lib = _build.library()
    return {name: int(lib.repro_activity_window_device_launches(i, int(reset)))
            for i, name in enumerate(DEVICE_MODES)}


def _split_src(in_edges, n: int):
    valid = in_edges >= 0
    src_rank = torch.where(valid, torch.div(in_edges, n, rounding_mode="floor"),
                           0)
    src_lid = torch.where(valid, torch.remainder(in_edges, n), 0)
    return valid, src_rank, src_lid


def local_spike_hits(spiked_last, in_edges, rank, n: int):
    """True spikes for same-rank edges ('virtually free' in the paper)."""
    valid, src_rank, src_lid = _split_src(in_edges, n)
    local = valid & (src_rank == rank)
    return local & spiked_last[src_lid]


def reconstruct_remote_spikes(seed: int, gstep, all_rates, in_edges, rank,
                              n: int, rate_slots=None):
    """NEW spike algorithm, receive side: Bernoulli(rate) per REMOTE edge from
    the counter hash keyed by ``(seed, SPIKE_DOMAIN, gstep, dst_gid*S +
    slot)``. Dense exchange (``rate_slots`` None): the rate is read from the
    replicated (R, n) table at the source's (rank, local id). Sparse
    exchange: ``all_rates`` is the compact (subs_cap,) subscribed-rate
    buffer and ``rate_slots`` the (n, S) edge -> slot remap; slot -1 (local,
    empty, or overflowed subscription) reads rate 0. Returns (n, S) bool
    (False on local/empty edges)."""
    s_max = in_edges.shape[1]
    valid, src_rank, src_lid = _split_src(in_edges, n)
    remote = valid & (src_rank != rank)
    if rate_slots is None:
        r = torch.clamp(src_rank, 0, all_rates.shape[0] - 1)
        rates = all_rates[r, src_lid]
    else:
        cap = all_rates.shape[0]
        rates = torch.where(rate_slots >= 0,
                            all_rates[torch.clamp(rate_slots, 0, cap - 1)
                                      .to(torch.int64)], 0.0)
    dev = in_edges.device
    dst_gid = rank * n + torch.arange(n, dtype=torch.int64, device=dev)
    edge_id = dst_gid[:, None] * s_max + torch.arange(s_max, dtype=torch.int64,
                                                      device=dev)
    u = chash.uniform(seed, chash.SPIKE_DOMAIN, gstep, edge_id)
    return remote & (u < rates)


def step_core(state, in_edges, w_table, rates, bg_mean, bg_std, izh,
              ca_consts, seed: int, gstep: int, rank: int, n: int,
              stim=None, lesions=None, remote_override=None,
              rate_slots=None):
    """One electrical step. state: (v, u, ca, ax, de, spiked, spike_count);
    izh: (a, b, c, d, nu, eps) scalars or (n,); ca_consts: (calcium_decay,
    calcium_beta); rates: the dense (R, n) table, or with ``rate_slots``
    ((n, S) int32) the sparse exchange's (subs_cap,) buffer;
    remote_override: the (n, S) bool remote-spike hits of the old spike
    exchange, or None to draw them from the rates; stim: ((E, n) f32 masks,
    ((amplitude, t0, t1), ...)) or None; lesions: ((W, n) bool masks,
    ((t0, t1), ...)) or None (``scenarios/protocol.py``). The event windows
    are compared with the int32-wrapped global step, as the reference's
    traced step counter. Returns the new 7-tuple."""
    v, u, ca, ax, de, spiked, spike_count = state
    # parameters as float32 tensors on the state's device: torch divides a
    # CUDA tensor by a Python scalar as a multiply by its reciprocal, which
    # would differ in the last bit from the kernel's (and the reference's)
    # true division ``ca / eps``
    a, b, c, d, nu, eps = (torch.as_tensor(x, dtype=torch.float32,
                                           device=v.device) for x in izh)
    ca_decay, ca_beta = ca_consts

    # ---- (a) synaptic input from the in-edge table -----------------------
    local_in = local_spike_hits(spiked, in_edges, rank, n)
    remote_in = remote_override if remote_override is not None else \
        reconstruct_remote_spikes(seed, gstep, rates, in_edges, rank, n,
                                  rate_slots=rate_slots)
    valid = in_edges >= 0
    src_lid = torch.remainder(torch.where(valid, in_edges, 0), n)
    weights = torch.where(valid, w_table[src_lid], 0.0)
    syn_in = torch.sum((local_in | remote_in).to(torch.float32) * weights,
                       dim=-1)

    # ---- (b) background noise --------------------------------------------
    gid = rank * n + torch.arange(n, dtype=torch.int64, device=v.device)
    noise = bg_mean + bg_std * chash.normal(seed, chash.NOISE_DOMAIN, gstep,
                                            gid)
    step = _wrap_i32(gstep)
    if stim is not None:
        masks, meta = stim
        for i, (amp, t0, t1) in enumerate(meta):
            active = torch.tensor(float(t0 <= step < t1), dtype=torch.float32,
                                  device=v.device)
            noise = noise + amp * active * masks[i]
    alive = None
    if lesions is not None:
        masks, meta = lesions
        alive = torch.ones(n, dtype=torch.bool, device=v.device)
        for i, (t0, t1) in enumerate(meta):
            if t0 <= step < t1:
                alive = alive & ~masks[i]

    # ---- (c) Izhikevich + calcium + element growth -----------------------
    u_prev = u
    i_t = syn_in + noise
    for _ in range(2):  # two half-ms Euler steps (reference Izhikevich impl)
        v = v + 0.5 * (0.04 * v * v + 5.0 * v + 140.0 - u + i_t)
    u = u + a * (b * v - u)
    fired = v >= 30.0
    v = torch.where(fired, c, v)
    u = torch.where(fired, u + d, u)
    if alive is not None:
        # a dead neuron does not fire, rests at c and keeps its u
        fired = fired & alive
        v = torch.where(alive, v, c)
        u = torch.where(alive, u, u_prev)
    firedf = fired.to(torch.float32)
    ca = ca + (-ca * ca_decay + ca_beta * firedf)
    spike_count = spike_count + firedf
    drive = nu * (1.0 - ca / eps)
    ax = torch.clamp_min(ax + drive, 0.0)
    de = torch.clamp_min(de + drive, 0.0)
    if alive is not None:
        ax = torch.where(alive, ax, 0.0)
        de = torch.where(alive, de, 0.0)
    return v, u, ca, ax, de, fired, spike_count


def window_plain(state, in_edges, w_table, rates, bg_mean, bg_std, chunk: int,
                 rank: int, *, seed: int, num_steps: int, izh, ca_consts,
                 stim=None, lesions=None, rate_slots=None, remote=None):
    """``num_steps`` iterations of ``step_core``. ``remote``: None, or a
    function of a step's 7-tuple state that returns that step's (n, S)
    remote-spike hits (the old spike exchange, a collective a step) or None
    (the new algorithm: the hits are drawn from the rates).
    Returns ``(state7, spikes_per_step)`` with the (num_steps,) f32 per-step
    fired counts."""
    n = state[0].shape[0]
    st = tuple(state)
    counts = []
    for t in range(num_steps):
        st = step_core(st, in_edges, w_table, rates, bg_mean, bg_std, izh,
                       ca_consts, seed, chunk * num_steps + t, rank, n,
                       stim=stim, lesions=lesions,
                       remote_override=None if remote is None else remote(st),
                       rate_slots=rate_slots)
        counts.append(torch.sum(st[5].to(torch.float32)))
    return st, torch.stack(counts)


def activity_window(state, in_edges, w_table, rates, bg_mean, bg_std,
                    chunk: int, rank: int, *, seed: int, num_steps: int, izh,
                    ca_consts, stim=None, lesions=None, rate_slots=None):
    """Run ``num_steps`` electrical steps (K1).

    state: 7-tuple (v, u, ca, ax, de, spiked (bool), spike_count), all (n,);
    in_edges: (n, S) int32; w_table: (n,) signed per-source weights; rates:
    the dense (R, n) table, or with ``rate_slots`` ((n, S) int32, the sparse
    exchange's edge -> slot remap) the compact (subs_cap,) buffer;
    bg_mean/bg_std: scalar or (n,); izh: 6-tuple, scalar or (n,);
    stim/lesions: the protocol tables of ``scenarios/protocol.py`` or None.
    Returns ``(state7, spikes_per_step)``; the inputs are left unchanged."""
    if in_edges.device.type != "cuda":
        return window_plain(state, in_edges, w_table, rates, bg_mean, bg_std,
                            chunk, rank, seed=seed, num_steps=num_steps,
                            izh=izh, ca_consts=ca_consts, stim=stim,
                            lesions=lesions, rate_slots=rate_slots)
    n = state[0].shape[0]
    s_max = in_edges.shape[1]
    dev = in_edges.device
    f32 = torch.float32

    def vec(x):
        # a scalar is filled on the card: torch.as_tensor(x, device=cuda)
        # would copy it from the host and wait for the stream
        if not isinstance(x, torch.Tensor):
            return torch.full((n,), float(x), dtype=f32, device=dev)
        return torch.broadcast_to(x.to(dev, f32), (n,)).contiguous()

    v, u, ca, ax, de, spike_count = (state[i].to(f32).contiguous()
                                     for i in (0, 1, 2, 3, 4, 6))
    # the flags are bytes of 0 or 1 to the kernel: a bool tensor as it is
    spk = state[5] if state[5].dtype in (torch.bool, torch.uint8) \
        else state[5].to(torch.bool)
    spk = spk.contiguous()
    out = [torch.empty_like(x) for x in (v, u, ca, ax, de, spike_count)]
    out.append(torch.empty(n, dtype=torch.bool, device=dev))
    bits = torch.empty(2 * (-(-n // 32)), dtype=torch.int32, device=dev)
    edges = in_edges.to(torch.int32).contiguous()
    w = w_table.to(f32).contiguous()
    rates = rates.to(f32).contiguous()
    slots = None if rate_slots is None else \
        rate_slots.to(torch.int32).contiguous()
    bgm, bgs = vec(bg_mean), vec(bg_std)
    izh = [vec(x) for x in izh]
    fired = torch.empty(num_steps, dtype=torch.int32, device=dev)
    stim_mask, stim_amp, stim_t = _event_operands(stim, n, f32, dev)
    les_mask, _, les_t = _event_operands(lesions, n, torch.uint8, dev)
    _build.require_cuda("activity_window", v, u, ca, ax, de, spike_count,
                        spk, *out, bits, edges, w, rates, bgm, bgs, *izh,
                        fired, stim_mask, stim_amp, stim_t, les_mask, les_t,
                        *(() if slots is None else (slots,)))
    if slots is None:
        if edges.shape != (n, s_max) or rates.dim() != 2 or \
                rates.shape[1] != n or w.shape != (n,):
            raise ValueError("activity_window: in_edges (n, S), rates (R, n) "
                             "and w_table (n,) must agree on n")
    elif edges.shape != (n, s_max) or slots.shape != (n, s_max) or \
            rates.dim() != 1 or rates.numel() < 1 or w.shape != (n,):
        raise ValueError("activity_window: in_edges and rate_slots (n, S), "
                         "rates (subs_cap,) and w_table (n,) must agree")
    lib = _build.library()
    rc = lib.repro_activity_window(
        v.data_ptr(), u.data_ptr(), ca.data_ptr(), ax.data_ptr(),
        de.data_ptr(), spike_count.data_ptr(), spk.data_ptr(),
        *(t.data_ptr() for t in out), bits.data_ptr(), edges.data_ptr(),
        w.data_ptr(), rates.data_ptr(),
        None if slots is None else slots.data_ptr(), rates.shape[0],
        bgm.data_ptr(), bgs.data_ptr(),
        *(t.data_ptr() for t in izh), stim_mask.data_ptr(),
        stim_amp.data_ptr(), stim_t.data_ptr(), stim_amp.shape[0],
        les_mask.data_ptr(), les_t.data_ptr(), les_t.shape[0],
        fired.data_ptr(), n, s_max,
        rates.shape[0] if slots is None else 1, int(rank),
        int(seed) & chash.M32, _wrap_i32(chunk * num_steps), num_steps,
        float(ca_consts[0]), float(ca_consts[1]), _build.stream())
    shape = f"n={n}, S={s_max}, rates {tuple(rates.shape)}, " \
        f"steps={num_steps}"
    if rc == _NO_COOPERATIVE_LAUNCH:
        raise RuntimeError(f"activity_window: the device does not take a "
                           f"cooperative launch ({shape})")
    _build.check(rc, f"activity_window ({shape})")
    launches.add()
    *state_out, spiked = out
    return (*state_out[:5], spiked, state_out[5]), fired.to(f32)


def _event_operands(table, n: int, mask_dtype, dev):
    """A protocol table as kernel operands: the (E, n) masks, the
    amplitudes of its stimulus events (entries ``(amplitude, t0, t1)``;
    lesion entries are ``(t0, t1)``) and the (E, 2) int32 windows."""
    masks, meta = table if table is not None else (
        torch.zeros((0, n), device=dev), ())
    if masks.shape != (len(meta), n):
        raise ValueError(f"activity_window: event masks {tuple(masks.shape)} "
                         f"do not match {len(meta)} events of {n} neurons")
    amps = [float(m[0]) for m in meta if len(m) == 3]
    windows = [[_wrap_i32(t) for t in m[-2:]] for m in meta]
    # non_blocking: a host tensor's bytes are staged at once, and the stream
    # is not waited for (torch.tensor(..., device=cuda) would wait)
    return (masks.to(mask_dtype).contiguous(),
            torch.tensor(amps, dtype=torch.float32).to(dev, non_blocking=True),
            torch.tensor(windows, dtype=torch.int32).reshape(-1, 2).to(
                dev, non_blocking=True))


def _wrap_i32(x: int) -> int:
    """int32 wrap-around, as the reference's traced step counter."""
    return ((int(x) + 2 ** 31) % 2 ** 32) - 2 ** 31
