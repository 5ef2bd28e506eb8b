"""The copied operation, byte and flop counts against values worked out
by hand at small shapes."""
from __future__ import annotations

import pytest


def test_attention_pairs_by_hand():
    from portbench.bench.work import attention_pairs
    assert attention_pairs(4, 4, 0) == 1 + 2 + 3 + 4
    # window 2: each query sees itself and the one before
    assert attention_pairs(5, 5, 2) == 1 + 2 + 2 + 2 + 2
    assert attention_pairs(4096, 4096, 0) == 4096 * 4097 // 2


def test_k9_counts_by_hand():
    from portbench.bench.work import k9_backward, k9_forward
    # B 1, 2 query heads, 1 kv head, S 4, D 8: 10 pairs a head
    f = k9_forward(1, 2, 1, 4, 8)
    assert f["flops"] == 4 * 8 * 10 * 2
    # q and o (2 x 64 el), k and v (2 x 32 el) in bf16, lse 2 x 4 f32
    assert f["bytes"] == (2 * 64 + 2 * 32) * 2 + 4 * 8
    b = k9_backward(1, 2, 1, 4, 8)
    assert b["flops"] == 5 * 2 * 8 * 10 * 2
    # q, o, dO, dq: 3 x 64 read + k, v, dk, dv: 4 x 32, bf16; lse f32
    assert b["bytes"] == 2 * (3 * 64 + 4 * 32) + 4 * 8


def test_train_step_flops_by_hand():
    from portbench.bench.work import train_step_flops
    # N 1,000, T 8 tokens (B 2 x S 4), 3 heads of 16, 2 layers:
    # 6 N T + 12 D pairs heads layers, pairs = 2 x 10
    assert train_step_flops(1000, 8, 2, 4, 3, 16, 2) == \
        6 * 1000 * 8 + 12 * 16 * 20 * 3 * 2


def test_k1_window_by_hand():
    from portbench.bench.work import HASH_OPS, NEURON_OPS, SLOT_OPS, \
        k1_window
    w = k1_window(n=10, s=4, steps=3, valid_edges=7, lesions=False)
    assert w["int_ops"] == 3 * (10 * HASH_OPS + 7 * SLOT_OPS)
    assert w["fp_ops"] == 3 * 10 * NEURON_OPS
    # state 25 n in and out, table 4 n S, weights, rates, ...: 102 n + 16 nS
    assert w["bytes"] == 25 * 10 + 16 * 10 + 4 * 10 + 4 * 10 + 8 * 10 + \
        24 * 10 + 25 * 10 + 4 * 3
    assert k1_window(10, 4, 3, 7, True)["bytes"] == w["bytes"] + 10


def test_bound_by_hand():
    from portbench.bench import peaks
    ms, by = peaks.bound(3.35e9)               # a GB at 3.35 TB/s
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = peaks.bound(0, fp_ops=989e9, fp_ops_per_s=peaks.BF16_OPS_PER_S)
    assert by == "operations" and ms == pytest.approx(1.0)
    assert peaks.INT32_OPS_PER_S == pytest.approx(16.72704e12)


def test_k2_work_one_leaf_query():
    """A two-level tree (8 leaves) holding one neuron in leaf 0 and a
    query at that neuron's leaf: round 0 evaluates the 8 children of the
    root; leaf 0 alone is nonempty, so the search settles in one
    sub-round with one frontier draw, and the member pick has one
    candidate (the neuron) to draw."""
    import torch
    from portbench.bench import work
    from portbench.reference import msp
    cfg = {"frontier_cap": 8, "local_levels": 1, "theta": 0.3,
           "sigma": 0.25, "seed": 7}
    counts = (torch.tensor([1.0]), torch.tensor([1.0] + [0.0] * 7))
    cents = (torch.tensor([[0.1, 0.1, 0.1]]),
             torch.tensor([[0.1, 0.1, 0.1]] + [[0.0] * 3] * 7))
    tree = msp.stack_levels(counts, cents, 1)
    members = torch.full((8, 4), -1, dtype=torch.int32)
    members[0, 0] = 0
    pos = torch.tensor([[0.1, 0.1, 0.1]])
    vac = torch.tensor([1.0])
    x = torch.tensor([[0.2, 0.2, 0.2]])
    w = work.k2_work(tree, members, pos, vac, x,
                     torch.zeros(1, dtype=torch.int32),
                     torch.tensor([5], dtype=torch.int32), cfg, chunk=0)
    assert w["queries"] == 1 and w["rounds"] == 1
    assert w["node_evaluations"] == 8
    assert w["frontier_draws"] == 1
    assert w["member_draws"] == 1
