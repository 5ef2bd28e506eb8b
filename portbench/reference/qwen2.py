"""The plain reference of a Qwen2 decoder's training step: the forward
pass, the loss, its gradients and the AdamW update, in plain PyTorch.

Written from the model's published description (Qwen2, arXiv 2407.10671;
the layer equations below) and from the program's stated training recipe,
not from the program's code, which it does not import. The weights it
reads are the benchmark's own draw from the seed, in the tree layout the
program is handed (``layers_stacked`` with a leading layer axis).

Per layer, with x the residual stream (B, S, d):
  h = rmsnorm(x) * ln1;  q, k, v = h Wq + bq, h Wk + bk, h Wv + bv
  q, k rotated by RoPE (half-split pairs, base ``rope_theta``)
  o = softmax(q k^T / sqrt(D) + causal mask) v, query heads grouped over
      the key-value heads (GQA);  x = x + o Wo
  h = rmsnorm(x) * ln2;  x = x + (silu(h Wg) * (h Wu)) Wd
then rmsnorm * final_norm, logits = x W_head, and the mean cross-entropy
of each position's next token.

Precision: every operation in float32 from the stored weights (TF32 off);
the stored state keeps the configuration's types (matrices, their
gradients, m and v in bfloat16; norms and biases in float32), and the
update is AdamW's element by element in float32 with the global-norm clip,
the linear warm-up and the decoupled weight decay on matrices.
``precision="fp8"`` rounds every matrix product's two operands to
float8 e4m3 (a scale a tensor): the control that ``correct`` must refuse.

Memory: one layer's weights in float32 at a time, the layers' inputs kept
and each layer recomputed in the backward.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F32 = torch.float32
SLICE = 1 << 26
FP8_MAX = 448.0


def leaves(tree, path=()):
    """(path, tensor) of every leaf, dict keys sorted."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(leaves(tree[k], path + (k,)))
        return out
    return [(path, tree)]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _fp8(x):
    """x rounded to float8 e4m3 with one scale for the tensor, back in
    float32."""
    s = torch.clamp_min(x.detach().abs().amax(), 1e-30) / FP8_MAX
    q = (x / s).to(torch.float8_e4m3fn).to(F32) * s
    return x + (q - x).detach()


class Precision:
    def __init__(self, name: str):
        if name not in ("float32", "fp8"):
            raise ValueError(f"precision {name!r}")
        self.fp8 = name == "fp8"

    def mm(self, a, b):
        if self.fp8:
            a, b = _fp8(a), _fp8(b)
        return a @ b


def rmsnorm(x, scale, eps):
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * scale


def rope(x, theta):
    """x: (B, H, S, D); pairs (i, i + D/2) rotated by the position times
    theta^(-2i/D)."""
    s, d = x.shape[-2], x.shape[-1]
    inv = 1.0 / torch.pow(float(theta), torch.arange(0, d, 2, dtype=F32,
                                                     device=x.device) / d)
    ang = torch.arange(s, dtype=F32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, prec: Precision):
    """Causal GQA attention in float32, one key-value head at a time."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    outs = []
    for j in range(hkv):
        qj = q[:, j * g:(j + 1) * g]
        sc = prec.mm(qj, k[:, j:j + 1].transpose(-1, -2)) / math.sqrt(d)
        p = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
        outs.append(prec.mm(p, v[:, j:j + 1]))
    return torch.cat(outs, dim=1)


def layer_forward(x, w, cfg, prec: Precision):
    """One decoder layer on float32 weights ``w`` (one layer's slice)."""
    b, s, dm = x.shape
    hd, hq, hkv = cfg["head_dim"], cfg["num_heads"], cfg["num_kv_heads"]
    eps = cfg["norm_eps"]
    h = rmsnorm(x, w["ln1"], eps)
    q = prec.mm(h, w["wq"]) + w["bq"]
    k = prec.mm(h, w["wk"]) + w["bk"]
    v = prec.mm(h, w["wv"]) + w["bv"]
    q = rope(q.reshape(b, s, hq, hd).transpose(1, 2), cfg["rope_theta"])
    k = rope(k.reshape(b, s, hkv, hd).transpose(1, 2), cfg["rope_theta"])
    v = v.reshape(b, s, hkv, hd).transpose(1, 2)
    o = attention(q, k, v, prec).transpose(1, 2).reshape(b, s, hq * hd)
    x = x + prec.mm(o, w["wo"])
    h = rmsnorm(x, w["ln2"], eps)
    return x + prec.mm(F.silu(prec.mm(h, w["w_gate"])) * prec.mm(h, w["w_up"]),
                       w["w_down"])


LAYER_KEYS = {"ln1": ("ln1", "scale"), "ln2": ("ln2", "scale"),
              "wq": ("attn", "wq"), "wk": ("attn", "wk"),
              "wv": ("attn", "wv"), "wo": ("attn", "wo"),
              "bq": ("attn", "bq"), "bk": ("attn", "bk"),
              "bv": ("attn", "bv"), "w_up": ("mlp", "w_up"),
              "w_gate": ("mlp", "w_gate"), "w_down": ("mlp", "w_down")}


def _layer_f32(stacked, i, grad: bool):
    w = {}
    for name, (a, b) in LAYER_KEYS.items():
        t = stacked[a][b][i].to(F32)
        w[name] = t.requires_grad_(True) if grad else t
    return w


def loss_and_grads(params, tokens, cfg, prec: Precision):
    """(loss, grads): the mean next-token cross-entropy of ``tokens`` (B,
    S) and its gradient, a tree like ``params`` in each leaf's type."""
    st = params["layers_stacked"]
    n_layers = st["ln1"]["scale"].shape[0]
    emb = params["embed"]["table"]
    x = F.embedding(tokens.long(), emb).to(F32)
    inputs = []
    with torch.no_grad():
        for i in range(n_layers):
            inputs.append(x)
            x = layer_forward(x, _layer_f32(st, i, False), cfg, prec)
    # the head and the loss with autograd, from the last layer's output
    x = x.detach().requires_grad_(True)
    fn = params["final_norm"]["scale"].detach().to(F32).requires_grad_(True)
    hw = params["head"]["w"].to(F32).requires_grad_(True)
    hn = rmsnorm(x, fn, cfg["norm_eps"])
    logits = prec.mm(hn[:, :-1], hw)
    labels = tokens[:, 1:].long()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
    loss = torch.mean(lse - tgt)
    gx, g_fn, g_hw = torch.autograd.grad(loss, (x, fn, hw))
    del logits, lse, tgt, hn
    grads = {"final_norm": {"scale": g_fn},
             "head": {"w": g_hw.to(params["head"]["w"].dtype)}}
    del g_hw
    layer_grads = {a: {b: torch.empty_like(st[a][b]) for b in st[a]}
                   for a in st}
    for i in reversed(range(n_layers)):
        xi = inputs[i].requires_grad_(True)
        w = _layer_f32(st, i, True)
        out = layer_forward(xi, w, cfg, prec)
        names = list(w)
        got = torch.autograd.grad(out, [xi] + [w[k] for k in names], gx)
        gx = got[0]
        for name, g in zip(names, got[1:]):
            a, b = LAYER_KEYS[name]
            layer_grads[a][b][i].copy_(g)
        inputs[i] = None
        del out, got, w
    grads["layers_stacked"] = layer_grads
    g_emb = torch.zeros(emb.shape, dtype=F32, device=emb.device)
    g_emb.index_add_(0, tokens.reshape(-1).long(),
                     gx.reshape(-1, gx.shape[-1]))
    grads["embed"] = {"table": g_emb.to(emb.dtype)}
    return loss.detach(), grads


# ----------------------------------------------------------------- AdamW
def lr_at(opt, step: int) -> float:
    warm = opt["lr"] * min((step + 1) / max(opt["warmup_steps"], 1), 1.0)
    if step < opt["warmup_steps"]:
        return warm
    t = min(max((step - opt["warmup_steps"])
                / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    return opt["lr"] * (opt["min_lr_frac"] + (1 - opt["min_lr_frac"])
                        * 0.5 * (1 + math.cos(math.pi * t)))


def init_opt(params, opt):
    dt = getattr(torch, opt["state_dtype"])
    return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                                device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                                device=p.device), params),
            "step": 0}


@torch.no_grad()
def adamw(params, grads, state, opt):
    """One AdamW step in place: the gradient scaled by clip / its global
    norm (at most 1), m and v in float32 rounded to their stored type,
    the update (m / c1) / (sqrt(v / c2) + eps), plus weight decay times
    the param on matrices, times the learning rate."""
    step = state["step"]
    total = torch.zeros((), dtype=torch.float64, device=next(iter(
        leaves(params)))[1].device)
    for _, g in leaves(grads):
        for i in range(0, g.numel(), SLICE):
            total += torch.sum(torch.square(g.reshape(-1)[i:i + SLICE]
                                            .to(torch.float64)))
    gn = float(torch.sqrt(total))
    scale = min(opt["grad_clip"] / max(gn, 1e-9), 1.0) \
        if opt["grad_clip"] > 0 else 1.0
    lr = lr_at(opt, step)
    c1 = 1.0 - opt["b1"] ** (step + 1)
    c2 = 1.0 - opt["b2"] ** (step + 1)
    for (_, p), (_, g), (_, m), (_, v) in zip(
            leaves(params), leaves(grads), leaves(state["m"]),
            leaves(state["v"])):
        decay = p.dim() >= 2
        pf, gf, mf, vf = (t.reshape(-1) for t in (p, g, m, v))
        for i in range(0, pf.numel(), SLICE):
            sl = slice(i, i + SLICE)
            gs = gf[sl].to(F32) * scale
            mn = mf[sl].to(F32) * opt["b1"] + gs * (1 - opt["b1"])
            vn = vf[sl].to(F32) * opt["b2"] + gs * gs * (1 - opt["b2"])
            u = (mn / c1) / (torch.sqrt(vn / c2) + opt["eps"])
            pv = pf[sl].to(F32)
            if decay:
                u = u + opt["weight_decay"] * pv
            pf[sl] = (pv - lr * u).to(p.dtype)
            mf[sl] = mn.to(m.dtype)
            vf[sl] = vn.to(v.dtype)
    state["step"] = step + 1
    return gn


def train(params, batches, cfg, opt, precision="float32", on_step=None):
    """Train ``params`` in place on each batch of ``batches`` ((B, S)
    token tensors): the losses, and ``on_step(i, params, state)`` after
    each step."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        prec = Precision(precision)
        state = init_opt(params, opt)
        losses = []
        for i, tokens in enumerate(batches):
            loss, grads = loss_and_grads(params, tokens, cfg, prec)
            adamw(params, grads, state, opt)
            del grads
            losses.append(float(loss))
            if on_step is not None:
                on_step(i, params, state)
        return losses
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev
