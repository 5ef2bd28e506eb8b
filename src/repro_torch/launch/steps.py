"""Step functions (train / prefill / decode) shared by the training driver
and the card's checks.

The port of the JAX package's ``repro/launch/steps.py``: a train step is
the loss's ``backward()`` on the params, then ``adamw_update`` in place;
eager PyTorch, so there is no ``jit``.

On a mesh (``mesh``: a ``dist.LocalMesh``, every rank in this process, or
a ``dist.ProcessMesh``, this process's rank) the params and the optimizer
state are trees of ``sharding.Sharded`` leaves and the batch is whole (each
rank slices its rows). A train step runs every rank's loss, then one
backward over all of them (``dist.backward_ranks``: each loss seeded with
1 / the mesh's rank count, the cotangent ``shard_map`` gives a replicated
output), then each rank's gradients summed over the axes its block is
copied along (``take_grads``) and its AdamW update, the clipping norm the
whole tree's. A leaf whose m and v split over ``pod`` further than the
param (ZeRO across pods, ``optimizer.shard_opt_state``) has its gradient
summed over the other axes only, then reduce-scattered over ``pod`` to m's
block (``optimizer.scatter_grads``). The prefill and decode steps run
every rank and return rank 0's logits (the whole batch's, the same on
every rank) and the list of every rank's decode state here.
"""
from __future__ import annotations

import torch

from repro_torch import dist
from repro_torch.configs.base import ModelConfig
from repro_torch.optim.optimizer import (OptimizerConfig, adamw_update,
                                         leaves, pod_dims, scatter_grads,
                                         tree_map)
from repro_torch.parallel import sharding as shd


def loss_and_grads(api, params, batch):
    """(loss, metrics, grads): the loss's backward on every param leaf
    (each made to require grad); the grads as a tree like ``params``,
    taken off the leaves (their ``.grad`` set back to None)."""
    for p in leaves(params):
        if not p.requires_grad:
            p.requires_grad_(True)
    loss, metrics = api.loss(params, batch)
    loss.backward()

    def take(p):
        g, p.grad = p.grad, None
        return g
    grads = tree_map(take, params)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def rank_loss(api, comm, params, batch):
    """Rank ``comm.rank``'s loss on its blocks of the ``Sharded`` params
    (each made to require grad), under ``use_mesh`` with the config's
    layout: (loss, metrics)."""
    local = shd.local_tree(params, comm.rank)
    for p in leaves(local):
        if not p.requires_grad:
            p.requires_grad_(True)
    with shd.use_mesh(comm, api.cfg.parallel.layout):
        return api.loss(local, batch, comm)


def take_grads(comm, params, skip=(), zero=None):
    """Rank ``comm.rank``'s gradients, in flatten order, taken off its
    blocks (``.grad`` set back to None): each summed over the axes its
    block is copied along (``sharding.replicated_axes``) but ``skip``; a
    leaf with a dim in ``zero`` (ZeRO across pods, ``optimizer.pod_dims``)
    not over ``pod`` either, since ``scatter_grads`` reduce-scatters it."""
    out = []
    local = leaves(shd.local_tree(params, comm.rank))
    for p, d in zip(local, zero or [None] * len(local)):
        g, p.grad = p.grad, None
        if g is None:
            g = torch.zeros_like(p)
        axes = shd.replicated_axes(p, comm, skip if d is None else
                                   tuple(skip) + ("pod",))
        out.append(comm.psum(g, axes) if axes else g)
    return out


def mesh_backward(size: int, outs):
    """The backward of every rank's loss here (``outs``: (loss, metrics)
    a rank), each seeded with 1 / ``size``, the rank count of the mesh the
    losses were computed on."""
    dist.backward_ranks([o[0] for o in outs], 1.0 / size)


def _detached(out):
    loss, metrics = out
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}


def make_train_step(api, mesh, opt_cfg: OptimizerConfig):
    if mesh is None:
        def train_step(params, opt_state, batch):
            loss, metrics, grads = loss_and_grads(api, params, batch)
            params, opt_state, stats = adamw_update(params, grads, opt_state,
                                                    opt_cfg)
            del grads
            out = dict(metrics)
            out.update(stats)
            out["loss"] = loss
            return params, opt_state, out
        return train_step

    def mesh_train_step(params, opt_state, batch):
        outs = mesh.run(lambda c: rank_loss(api, c, params, batch))
        mesh_backward(mesh.size, outs)
        loss, metrics = _detached(outs[0])

        def update(comm):
            lp = shd.local_tree(params, comm.rank)
            lo = shd.local_tree(opt_state, comm.rank)
            zero = pod_dims(lp, lo["m"])
            grads = scatter_grads(comm, take_grads(comm, params, zero=zero),
                                  lp, lo["m"], zero)
            _, new, stats = adamw_update(lp, grads, lo, opt_cfg, mesh=comm,
                                         zero=zero)
            return new["step"], stats
        res = mesh.run(update)
        opt_state = dict(opt_state, step=res[0][0])
        out = dict(metrics)
        out.update(res[0][1])
        out["loss"] = loss
        return params, opt_state, out
    return mesh_train_step


def make_prefill_step(api, mesh):
    def prefill_step(params, batch):
        with torch.no_grad():
            if mesh is None:
                return api.prefill(params, batch)

            def one(comm):
                with shd.use_mesh(comm):
                    return api.prefill(shd.local_tree(params, comm.rank),
                                       batch, comm)
            outs = mesh.run(one)
            return outs[0][0], [o[1] for o in outs]
    return prefill_step


def make_decode_step(api, mesh):
    """On a mesh ``state`` is the list of every rank's state here, as the
    prefill step gives it."""
    def decode_step(params, state, tokens):
        with torch.no_grad():
            if mesh is None:
                return api.decode_step(params, state, tokens)

            def one(comm):
                with shd.use_mesh(comm):
                    return api.decode_step(shd.local_tree(params, comm.rank),
                                           state[mesh.ranks.index(comm.rank)],
                                           tokens, comm)
            outs = mesh.run(one)
            return outs[0][0], [o[1] for o in outs]
    return decode_step


def opt_config_for(cfg: ModelConfig, *, steps: int = 10_000) -> \
        OptimizerConfig:
    warm = max(min(steps // 10, 100), 5)
    return OptimizerConfig(state_dtype=cfg.parallel.opt_state_dtype,
                           lr=1e-3, warmup_steps=warm, total_steps=steps)
