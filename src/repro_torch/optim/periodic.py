"""Delta-periodic gradient synchronisation, the port of the JAX package's
``repro/optim/periodic.py`` in its form without a ``pod`` axis.

The paper replaces per-step spike exchange with rate exchange every Delta
steps; the JAX module maps that onto training: gradients are accumulated
locally and exchanged across pods every Delta-th step. On one device there
is no pod to exchange with: ``accum_step`` adds each step's gradient (f32)
into an accumulator with a leading axis of size 1, and ``sync_step`` divides
by that axis's size, as the JAX no-pod branch takes the mean over it, then
applies AdamW and zeroes the accumulator. A mesh (a ``pod`` axis) and
``compress_int8`` raise: the cross-pod exchange and its int8 compression
are ROADMAP Queue 1 item 14f.
"""
from __future__ import annotations

import torch

from repro_torch.launch.steps import loss_and_grads
from repro_torch.models.layers import LATER
from repro_torch.optim.optimizer import (OptimizerConfig, adamw_update,
                                         leaves, tree_map)


def _no_pod(mesh):
    if mesh is not None:
        raise NotImplementedError(
            f"periodic sync across pods needs a mesh: {LATER['mesh']}")


def init_accumulator(params, mesh=None):
    """Per-pod grad accumulator, (1,) + each leaf's shape in f32."""
    _no_pod(mesh)
    return tree_map(lambda p: torch.zeros((1,) + tuple(p.shape),
                                          dtype=torch.float32,
                                          device=p.device), params)


def init_error(params, mesh=None):
    _no_pod(mesh)
    return init_accumulator(params, mesh)


def make_periodic_steps(api, mesh, opt_cfg: OptimizerConfig, *,
                        compress_int8: bool = False):
    """Returns (accum_step, sync_step).

    accum_step(params, acc, batch)            -> (acc, metrics)
    sync_step(params, opt_state, acc, err)    -> (params, opt, acc, err, stats)
    """
    _no_pod(mesh)
    if compress_int8:
        raise NotImplementedError(
            f"int8-compressed sync is the cross-pod exchange's: "
            f"{LATER['mesh']}")

    def accum_step(params, acc, batch):
        loss, metrics, grads = loss_and_grads(api, params, batch)
        with torch.no_grad():
            for a, g in zip(leaves(acc), leaves(grads)):
                if g is not None:
                    a.add_(g.to(torch.float32)[None])
        return acc, dict(metrics, loss=loss)

    @torch.no_grad()
    def sync_step(params, opt_state, acc, err):
        # the grads as a list in the params' flatten order, which is all
        # adamw_update reads of them
        grads = [(a.sum(dim=0) / a.shape[0]).to(p.dtype)
                 for a, p in zip(leaves(acc), leaves(params))]
        params, opt_state, stats = adamw_update(params, grads, opt_state,
                                                opt_cfg)
        for a in leaves(acc):
            a.zero_()
        return params, opt_state, acc, err, stats

    return accum_step, sync_step
