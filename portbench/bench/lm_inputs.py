"""The LM cells' inputs, made from the seed on the device: the weights,
in the types they are trained in, and the token batches.

Each weight leaf is one draw from a ``torch.Generator`` of its own (seeded
from the run's seed and the leaf's index), so any leaf can be drawn again
alone: the reference and the parameter-change readings redraw the initial
weights leaf by leaf instead of keeping a copy. Matrices are N(0, 1) times
the scale of the program's initialiser (``models/transformer.py``,
``models/layers.py``: d^-1/2 for the projections in, (H D)^-1/2 for the
attention output, d_ff^-1/2 for the MLP's down projection, 0.02 for the
embedding, d^-1/2 for the head), drawn in bfloat16; norm scales are ones
and biases zeros in float32. The tree is the program's layout, its layers
stacked on a leading axis.
"""
from __future__ import annotations

import torch

MIX = 0x9E3779B97F4A7C15


def leaf_specs(c: dict) -> list:
    """(path, shape, kind, scale) of every leaf, in sorted-key order."""
    d, ff, v = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    hq, hkv = c["num_attention_heads"], c["num_key_value_heads"]
    hd = d // hq
    L = c["num_hidden_layers"]
    qd, kvd = hq * hd, hkv * hd
    specs = [
        (("embed", "table"), (v, d), "normal", 0.02),
        (("final_norm", "scale"), (d,), "ones", None),
        (("head", "w"), (d, v), "normal", d ** -0.5),
        (("layers_stacked", "attn", "bk"), (L, kvd), "zeros", None),
        (("layers_stacked", "attn", "bq"), (L, qd), "zeros", None),
        (("layers_stacked", "attn", "bv"), (L, kvd), "zeros", None),
        (("layers_stacked", "attn", "wk"), (L, d, kvd), "normal", d ** -0.5),
        (("layers_stacked", "attn", "wo"), (L, qd, d), "normal", qd ** -0.5),
        (("layers_stacked", "attn", "wq"), (L, d, qd), "normal", d ** -0.5),
        (("layers_stacked", "attn", "wv"), (L, d, kvd), "normal", d ** -0.5),
        (("layers_stacked", "ln1", "scale"), (L, d), "ones", None),
        (("layers_stacked", "ln2", "scale"), (L, d), "ones", None),
        (("layers_stacked", "mlp", "w_down"), (L, ff, d), "normal",
         ff ** -0.5),
        (("layers_stacked", "mlp", "w_gate"), (L, d, ff), "normal",
         d ** -0.5),
        (("layers_stacked", "mlp", "w_up"), (L, d, ff), "normal", d ** -0.5),
    ]
    return specs


def _seed(seed: int, index: int) -> int:
    return (int(seed) * 1_000_003 + index * 7919 + MIX) % (1 << 63)


def make_leaf(spec, index: int, seed: int, dtype, device):
    _, shape, kind, scale = spec
    if kind == "ones":
        return torch.ones(shape, dtype=torch.float32, device=device)
    if kind == "zeros":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(_seed(seed, index))
    return torch.randn(shape, generator=g, dtype=dtype,
                       device=device).mul_(scale)


def make_params(c: dict, seed: int, device) -> dict:
    dtype = getattr(torch, c["torch_dtype"])
    tree = {}
    for i, spec in enumerate(leaf_specs(c)):
        node = tree
        for k in spec[0][:-1]:
            node = node.setdefault(k, {})
        node[spec[0][-1]] = make_leaf(spec, i, seed, dtype, device)
    return tree


def make_tokens(vocab: int, seed: int, count: int, batch: int, seq: int,
                device):
    """(count, batch, seq) int32 token ids, uniform over the vocabulary:
    ``count`` distinct batches."""
    g = torch.Generator(device=device)
    g.manual_seed(_seed(seed, 1 << 20))
    return torch.randint(0, vocab, (count, batch, seq), generator=g,
                         dtype=torch.int32, device=device)
