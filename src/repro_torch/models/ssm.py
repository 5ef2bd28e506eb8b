"""xLSTM blocks: mLSTM (matrix memory, exponential gating) and sLSTM
(scalar memory, block-diagonal recurrence).

The port of the JAX package's ``repro/models/ssm.py``. The recurrences are
sequential scans over time, one Python step a position, as
``jax.lax.scan`` runs them; the stabiliser ``m`` and the states stay in
float32, and the outputs are cast to x's dtype where JAX casts. With
``return_state`` a scan also returns its final carry, the decode state
after the last position (JAX's prefill replays the step form over the
sequence for it, ``decode._mlstm_final_state`` / ``_slstm_final_state``).
Decode carries an O(1) state. On ``meta`` (the dry run, which computes no
value) a scan traces its first two steps, the second counted as the other
``S - 1`` (``dist.repeated``).

State layout (per block):
  mlstm: C (B,H,hd,hd), n (B,H,hd), m (B,H)
  slstm: h,c,n (B,H,hd), m (B,H)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import repeated
from repro_torch.models.layers import (apply_rmsnorm, dtype_of,
                                       init_rmsnorm, normal)
from repro_torch.models.rglru import softplus

F32 = torch.float32


# =============================================================== mLSTM
def init_mlstm(gen, cfg: ModelConfig, d: int, device, lead=()):
    h = cfg.num_heads
    inner = h * cfg.head_dim
    dt = dtype_of(cfg)
    s = d ** -0.5
    si = inner ** -0.5
    b_if = torch.cat([torch.zeros((h,), dtype=F32, device=device),
                      torch.full((h,), 3.0, dtype=F32, device=device)])
    return {
        "norm": init_rmsnorm(d, device, lead),
        "w_up": normal(gen, lead + (d, 2 * inner), s, dt, device),  # x_m, z
        "w_q": normal(gen, lead + (inner, inner), si, dt, device),
        "w_k": normal(gen, lead + (inner, inner), si, dt, device),
        "w_v": normal(gen, lead + (inner, inner), si, dt, device),
        "w_if": normal(gen, lead + (inner, 2 * h), si, F32, device),
        "b_if": b_if.expand(lead + (2 * h,)).clone(),
        "w_down": normal(gen, lead + (inner, d), si, dt, device),
        "out_norm": init_rmsnorm(inner, device, lead),
    }


def _mlstm_gates(p, xm, h):
    gf = xm.to(F32) @ p["w_if"] + p["b_if"]
    i_log, f_log = gf[..., :h], gf[..., h:]
    log_f = -softplus(-f_log)      # log sigmoid(f)
    return i_log, log_f


def _mlstm_proj(p, cfg: ModelConfig, x):
    """x: (..., d) -> q, k, v (..., H, hd) float32 (k scaled), the gates
    (..., H) and z (..., inner)."""
    h, hd = cfg.num_heads, cfg.head_dim
    inner = h * hd
    lead = x.shape[:-1]
    xn = apply_rmsnorm(p["norm"], x, cfg.norm_eps)
    up = xn @ p["w_up"]
    xm, z = up[..., :inner], up[..., inner:]
    q = (xm @ p["w_q"]).reshape(lead + (h, hd)).to(F32)
    k = ((xm @ p["w_k"]).reshape(lead + (h, hd)) * hd ** -0.5).to(F32)
    v = (xm @ p["w_v"]).reshape(lead + (h, hd)).to(F32)
    i_log, log_f = _mlstm_gates(p, xm, h)
    return q, k, v, i_log, log_f, z


def _mlstm_cell(qt, kt, vt, it, ft, state):
    """One step of the recurrence from (C, n, m): (h_t f32, new state)."""
    m_new = torch.maximum(ft + state["m"], it)
    fs = torch.exp(ft + state["m"] - m_new)[..., None]
    is_ = torch.exp(it - m_new)[..., None]
    c_new = fs[..., None] * state["C"] + is_[..., None] * (
        kt[..., :, None] * vt[..., None, :])
    n_new = fs * state["n"] + is_ * kt
    denom = torch.maximum(torch.abs(torch.sum(n_new * qt, -1)),
                          torch.exp(-m_new))[..., None]
    ht = torch.einsum("bhd,bhde->bhe", qt, c_new) / denom
    return ht, {"C": c_new, "n": n_new, "m": m_new}


def _mlstm_out(p, cfg: ModelConfig, x, hs, z):
    hs = apply_rmsnorm(p["out_norm"], hs, cfg.norm_eps)
    return x + (hs * F.silu(z)) @ p["w_down"]


def mlstm_scan(p, cfg: ModelConfig, x, *, return_state=False):
    """x: (B,S,d) -> (B,S,d). Recurrent form, a step a position; with
    ``return_state`` also the final (C, n, m)."""
    b, s, d = x.shape
    inner = cfg.num_heads * cfg.head_dim
    q, k, v, i_log, log_f, z = _mlstm_proj(p, cfg, x)
    st = mlstm_init_state(cfg, b, x.device)
    hs = torch.empty((b, s, cfg.num_heads, cfg.head_dim), dtype=x.dtype,
                     device=x.device)
    if x.device.type == "meta" and s > 1:
        # the dry run: the first step (its carry holds no gradient), then
        # the second counted as the other s - 1
        for t, n in ((0, 1), (1, s - 1)):
            ht, st = repeated(n, _mlstm_cell, q[:, t], k[:, t], v[:, t],
                              i_log[:, t], log_f[:, t], st)
            hs[:, t] = ht.to(x.dtype)
    else:
        for t in range(s):
            ht, st = _mlstm_cell(q[:, t], k[:, t], v[:, t], i_log[:, t],
                                 log_f[:, t], st)
            hs[:, t] = ht.to(x.dtype)
    out = _mlstm_out(p, cfg, x, hs.reshape(b, s, inner), z)
    return (out, st) if return_state else out


def mlstm_init_state(cfg: ModelConfig, batch: int, device):
    h, hd = cfg.num_heads, cfg.head_dim
    return {"C": torch.zeros((batch, h, hd, hd), dtype=F32, device=device),
            "n": torch.zeros((batch, h, hd), dtype=F32, device=device),
            "m": torch.zeros((batch, h), dtype=F32, device=device)}


def mlstm_step(p, cfg: ModelConfig, x_t, state):
    """x_t: (B,d) single token. Returns (y (B,d), new state)."""
    b = x_t.shape[0]
    q, k, v, it, ft, z = _mlstm_proj(p, cfg, x_t)
    ht, new = _mlstm_cell(q, k, v, it, ft, state)
    hs = ht.reshape(b, cfg.num_heads * cfg.head_dim).to(x_t.dtype)
    return _mlstm_out(p, cfg, x_t, hs, z), new


# =============================================================== sLSTM
def init_slstm(gen, cfg: ModelConfig, d: int, device, lead=()):
    h = cfg.sslstm_heads
    hd = d // h
    dt = dtype_of(cfg)
    return {
        "norm": init_rmsnorm(d, device, lead),
        "w_x": normal(gen, lead + (d, 4 * d), d ** -0.5, F32, device),  # ifzo
        "r_h": normal(gen, lead + (h, hd, 4 * hd), hd ** -0.5, F32, device),
        "b": torch.zeros(lead + (4 * d,), dtype=F32, device=device),
        "w_down": normal(gen, lead + (d, d), d ** -0.5, dt, device),
        "out_norm": init_rmsnorm(d, device, lead),
    }


def _slstm_cell(p, cfg: ModelConfig, wx_t, carry):
    """wx_t: (B, 4d) precomputed input proj; carry: dict of (B,H,hd)."""
    h_heads = cfg.sslstm_heads
    hprev = carry["h"]
    b, hd = hprev.shape[0], hprev.shape[-1]
    rec = torch.einsum("bhd,hde->bhe", hprev, p["r_h"])   # (B,H,4hd)
    gates = wx_t.reshape(b, h_heads, 4 * hd) + rec
    i_l, f_l, z_l, o_l = torch.split(gates, hd, dim=-1)
    log_f = -softplus(-f_l)
    m_new = torch.amax(torch.maximum(log_f + carry["m"][..., None], i_l),
                       dim=-1)                            # shared stabiliser
    fs = torch.exp(log_f + carry["m"][..., None] - m_new[..., None])
    is_ = torch.exp(i_l - m_new[..., None])
    c_new = fs * carry["c"] + is_ * torch.tanh(z_l)
    n_new = fs * carry["n"] + is_
    h_new = torch.sigmoid(o_l) * c_new / torch.clamp_min(n_new, 1e-6)
    return {"h": h_new, "c": c_new, "n": n_new, "m": m_new}


def _slstm_in(p, cfg: ModelConfig, x):
    xn = apply_rmsnorm(p["norm"], x, cfg.norm_eps)
    return xn.to(F32) @ p["w_x"] + p["b"]


def _slstm_out(p, cfg: ModelConfig, x, hs):
    hs = apply_rmsnorm(p["out_norm"], hs, cfg.norm_eps)
    return x + hs @ p["w_down"]


def slstm_scan(p, cfg: ModelConfig, x, *, return_state=False):
    """x: (B,S,d) -> (B,S,d), a step a position; with ``return_state``
    also the final (h, c, n, m)."""
    b, s, d = x.shape
    wx = _slstm_in(p, cfg, x)                             # (B,S,4d)
    carry = slstm_init_state(cfg, b, d, x.device)
    hs = torch.empty((b, s, d), dtype=x.dtype, device=x.device)
    if x.device.type == "meta" and s > 1:
        # the dry run: the first step, then the second counted as s - 1
        for t, n in ((0, 1), (1, s - 1)):
            carry = repeated(n, lambda p_, w_, c_: _slstm_cell(p_, cfg, w_,
                                                               c_),
                             p, wx[:, t], carry)
            hs[:, t] = carry["h"].reshape(b, d).to(x.dtype)
    else:
        for t in range(s):
            carry = _slstm_cell(p, cfg, wx[:, t], carry)
            hs[:, t] = carry["h"].reshape(b, d).to(x.dtype)
    out = _slstm_out(p, cfg, x, hs)
    return (out, carry) if return_state else out


def slstm_init_state_inner(cfg: ModelConfig, batch: int, hd: int, device):
    h = cfg.sslstm_heads
    z = torch.zeros((batch, h, hd), dtype=F32, device=device)
    return {"h": z, "c": z.clone(), "n": z + 1e-6,
            "m": torch.zeros((batch, h), dtype=F32, device=device)}


def slstm_init_state(cfg: ModelConfig, batch: int, d: int, device):
    return slstm_init_state_inner(cfg, batch, d // cfg.sslstm_heads, device)


def slstm_step(p, cfg: ModelConfig, x_t, state):
    b, d = x_t.shape
    new = _slstm_cell(p, cfg, _slstm_in(p, cfg, x_t), state)
    hs = new["h"].reshape(b, d).to(x_t.dtype)
    return _slstm_out(p, cfg, x_t, hs), new
