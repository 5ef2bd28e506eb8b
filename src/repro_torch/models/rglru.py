"""RG-LRU recurrent block (RecurrentGemma / Griffin).

The port of the JAX package's ``repro/models/rglru.py``. The gated linear
recurrence h_t = a_t * h_{t-1} + sqrt(1-a_t^2) * (i_t * x_t) runs over the
sequence as a log-depth (Hillis-Steele) scan of JAX's ``combine`` in tensor
ops (``associative_scan``): ceil(log2 S) passes, each over the whole
(B, S, W) operand, in place of ``jax.lax.associative_scan`` (not a Python
loop of S steps, and not a log-space cumsum, which loses precision at S in
the thousands). Decode carries an O(1) state: h and a width-(K-1) conv tail.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (apply_rmsnorm, dtype_of, gelu,
                                       init_rmsnorm, normal, zeros)

_C = 8.0  # decay sharpness constant from the Griffin paper
F32 = torch.float32


def softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) with no threshold (F.softplus
    returns x above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init_rglru(gen, cfg: ModelConfig, d: int, device, lead=()):
    w = d  # lru width = d_model (recurrentgemma-2b)
    dt = dtype_of(cfg)
    s = d ** -0.5
    p = {
        "norm": init_rmsnorm(d, device, lead),
        "w_x": normal(gen, lead + (d, w), s, dt, device),   # recurrent in-proj
        "w_g": normal(gen, lead + (d, w), s, dt, device),   # gate in-proj
        "conv": normal(gen, lead + (cfg.rglru_conv_width, w), 0.3, F32,
                       device),
        "w_ir": normal(gen, lead + (w, 2 * w), s, F32, device),
        "b_ir": zeros(lead + (2 * w,), device),
        "w_out": normal(gen, lead + (w, d), s, dt, device),
        "conv_bias": zeros(lead + (w,), device),
    }
    # Lambda init so decay a in [0.9, 0.999] at r=1 (griffin appendix)
    lo, hi = 0.9 ** 2, 0.999 ** 2
    u = torch.rand(lead + (w,), generator=gen, dtype=F32, device=device)
    u = u * (hi - lo) + lo
    p["lambda"] = torch.log(torch.expm1(-torch.log(u) / (2 * _C)))
    return p


def _conv1d_causal(x, kernel, bias):
    """Depthwise causal conv. x: (B,S,W), kernel: (K,W)."""
    k = kernel.shape[0]
    xp = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    out = 0
    for i in range(k):
        out = out + xp[:, i: i + x.shape[1], :] * kernel[i]
    return out + bias


def _gates(p, xc):
    """xc: (..., W) f32 -> (log_a, in_gate)."""
    ir = xc @ p["w_ir"] + p["b_ir"]
    w = p["lambda"].shape[0]
    i_g = torch.sigmoid(ir[..., :w])
    r_g = torch.sigmoid(ir[..., w:])
    log_a = -_C * r_g * softplus(p["lambda"])
    return log_a, i_g


def associative_scan(a, b):
    """Inclusive scan over axis 1 of (a, b) under JAX's combine
    ((al, bl), (ar, br)) -> (al * ar, bl * ar + br): after the pass with
    offset o, element t holds the combine of elements t-2o+1 .. t
    (Hillis-Steele). Returns (a's products, h)."""
    s = a.shape[1]
    off = 1
    while off < s:
        al, bl = a[:, :-off], b[:, :-off]
        ar, br = a[:, off:], b[:, off:]
        a = torch.cat([a[:, :off], al * ar], dim=1)
        b = torch.cat([b[:, :off], bl * ar + br], dim=1)
        off *= 2
    return a, b


def _recurrence(p, cfg: ModelConfig, x):
    """x: (B,S,d) -> (h (B,S,W) f32, gate (B,S,W) f32, xb (B,S,W) f32)."""
    xn = apply_rmsnorm(p["norm"], x, cfg.norm_eps)
    xb = (xn @ p["w_x"]).to(F32)
    gate = gelu((xn @ p["w_g"]).to(F32))
    xc = _conv1d_causal(xb, p["conv"], p["conv_bias"])
    log_a, i_g = _gates(p, xc)
    a = torch.exp(log_a)
    bterm = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i_g * xc)
    _, h = associative_scan(a, bterm)
    return h, gate, xb


def rglru_forward(p, cfg: ModelConfig, x, *, return_state=False):
    """x: (B,S,d) -> (B,S,d), the full-sequence parallel form; with
    ``return_state`` also the decode state after the last position (JAX's
    ``decode._rglru_prefill`` recomputes the same scan for it)."""
    h, gate, xb = _recurrence(p, cfg, x)
    out = x + (h * gate).to(x.dtype) @ p["w_out"]
    if not return_state:
        return out
    kw = cfg.rglru_conv_width - 1
    return out, {"h": h[:, -1, :], "conv_tail": xb[:, -kw:, :]}


def rglru_init_state(cfg: ModelConfig, batch: int, d: int, device):
    w = d
    return {"h": torch.zeros((batch, w), dtype=F32, device=device),
            "conv_tail": torch.zeros((batch, cfg.rglru_conv_width - 1, w),
                                     dtype=F32, device=device)}


def rglru_step(p, cfg: ModelConfig, x_t, state):
    """x_t: (B,d) -> (y, new_state)."""
    xn = apply_rmsnorm(p["norm"], x_t, cfg.norm_eps)
    xb = (xn @ p["w_x"]).to(F32)
    gate = gelu((xn @ p["w_g"]).to(F32))
    hist = torch.cat([state["conv_tail"], xb[:, None, :]], dim=1)
    xc = torch.sum(hist * p["conv"], dim=1) + p["conv_bias"]
    log_a, i_g = _gates(p, xc)
    a = torch.exp(log_a)
    h = a * state["h"] + torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (
        i_g * xc)
    y = (h * gate).to(x_t.dtype) @ p["w_out"]
    return x_t + y, {"h": h, "conv_tail": hist[:, 1:, :]}
