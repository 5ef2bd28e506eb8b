"""Step functions (train / prefill / decode) shared by the training driver
and the card's checks.

The port of the JAX package's ``repro/launch/steps.py`` on one device: a
train step is the loss's ``backward()`` on the params, then
``adamw_update`` in place; eager PyTorch, so there is no ``jit``. A
``mesh`` raises (the sharded paths are ROADMAP Queue 1 item 14f).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import no_mesh
from repro_torch.optim.optimizer import (OptimizerConfig, adamw_update,
                                         leaves, tree_map)


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


def make_train_step(api, mesh, opt_cfg: OptimizerConfig):
    no_mesh(mesh)

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


def make_prefill_step(api, mesh):
    no_mesh(mesh)

    def prefill_step(params, batch):
        with torch.no_grad():
            return api.prefill(params, batch)
    return prefill_step


def make_decode_step(api, mesh):
    no_mesh(mesh)

    def decode_step(params, state, tokens):
        with torch.no_grad():
            return api.decode_step(params, state, tokens)
    return decode_step


def opt_config_for(cfg: ModelConfig, *, steps: int = 10_000) -> \
        OptimizerConfig:
    warm = max(min(steps // 10, 100), 5)
    return OptimizerConfig(state_dtype=cfg.parallel.opt_state_dtype,
                           lr=1e-3, warmup_steps=warm, total_steps=steps)
