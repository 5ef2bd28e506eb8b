"""GPipe-style pipeline parallelism over a mesh axis: the port of the JAX
package's ``repro/parallel/pipeline.py``.

Each stage owns a contiguous slice of layers (the stacked params' leading
dim, ``S * L_per_stage``, split over the stage axis). A step runs M
microbatches through S stages in M+S-1 ticks; the activation handoff is one
``ppermute`` a tick, and the last stage's outputs reach every stage through
a ``psum`` of the outputs masked to it. Each rank runs ``pipeline_apply``
with its ``dist.MeshComm``.
"""
from __future__ import annotations

import torch

from repro_torch.parallel import sharding as shd


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return shd.sub_spec(tree, tree[i])


def _stage_block(tree, mesh, axis):
    if isinstance(tree, dict):
        return {k: _stage_block(v, mesh, axis) for k, v in tree.items()}
    return shd.as_spec(tree, mesh, shd.P(axis))


def pipeline_apply(layer_fn, stage_params, x_microbatches, mesh,
                   axis="stage"):
    """layer_fn(params_slice, x) -> x; stage_params: the stacked leaves,
    this rank's block (L_per_stage, ...) along ``axis`` (a leaf that
    carries the spec ``P(axis)``) or the whole stack (sliced here).
    x_microbatches: (M, mb, ...), the same on every rank. Returns (M, mb,
    ...) outputs on every rank."""
    s = mesh.shape[axis]
    idx = mesh.axis_index(axis)
    stage_p = _stage_block(stage_params, mesh, axis)
    xs = x_microbatches
    m = xs.shape[0]
    n_layers = next(iter(_leaves(stage_p))).shape[0]

    def stage_compute(x):
        for i in range(n_layers):
            x = layer_fn(_index(stage_p, i), x)
        return x

    buf = torch.zeros_like(xs[0])
    outs = [torch.zeros_like(xs[0]) for _ in range(m)]
    for t in range(m + s - 1):
        # stage 0 ingests microbatch t (if any)
        feed = min(t, m - 1)
        x_in = (1.0 if (idx == 0 and t < m) else 0.0) * xs[feed] + \
            (0.0 if idx == 0 else 1.0) * buf
        y = stage_compute(x_in)
        # hand off to the next stage; last stage's output is collected
        out_t = t - (s - 1)
        if idx == s - 1 and 0 <= out_t < m:
            outs[out_t] = y
        buf = mesh.ppermute(y, axis, [(i, (i + 1) % s) for i in range(s)])
    out = torch.stack(outs)
    # only the last stage holds the outputs; psum-broadcast to all
    if s > 1:
        out = mesh.psum(out if idx == s - 1 else torch.zeros_like(out), axis)
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
