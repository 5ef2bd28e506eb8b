"""Delta-periodic cross-pod gradient synchronisation: the port of the JAX
package's ``repro/optim/periodic.py``, the paper's second algorithm mapped
onto distributed training.

The paper replaces per-step spike exchange with rate exchange every Delta
steps. Here: within a pod gradients are reduced every step; across pods
they are only accumulated, each pod its own accumulator, and exchanged
every Delta-th step: semantically exact large-batch training with the
cross-pod bytes divided by Delta (optionally int8-compressed with error
feedback on top, ``parallel/compress.py``).

Mechanics, on a mesh with a ``pod`` axis (``mesh``: a ``dist.LocalMesh`` or
``dist.ProcessMesh``): ``accum_step`` runs each pod as a model of its own
(the rank's view without ``pod``, ``MeshComm.without``, as JAX's
``shard_map`` manual over ``pod`` only): the pod's rows of the batch, its
loss, its gradients reduced inside the pod, added to the pod's block of
the accumulator, which carries a leading axis of the pod count (each pod's
block (1, ...)); no collective crosses the pods. ``sync_step`` takes the
mean over pods (a ``psum`` over ``pod``, or the int8 all-gather), applies
AdamW and zeroes the accumulator. Where m and v split a leaf over ``pod``
further than the param (ZeRO across pods, ``optimizer.shard_opt_state``),
the exact sync reduce-scatters that leaf's accumulator over ``pod`` to m's
block instead, and the int8 one takes m's block of its mean
(``optimizer.scatter_grads``). Without a ``pod`` axis (or without a
mesh) every slot of the leading axis holds the globally reduced gradient
and the sync takes the mean over that axis, as JAX's fallback; int8 then
does not apply.
"""
from __future__ import annotations

import torch

from repro_torch.launch import steps
from repro_torch.optim.optimizer import (OptimizerConfig, adamw_update,
                                         leaves, pod_dims, scatter_grads,
                                         tree_map)
from repro_torch.parallel import compress
from repro_torch.parallel import sharding as shd

F32 = torch.float32


def _pods(mesh) -> int:
    return mesh.shape.get("pod", 1) if mesh is not None else 1


def init_accumulator(params, mesh=None):
    """Per-pod grad accumulator: (pods,) + each leaf's shape in f32 (a
    mesh's ``Sharded`` leaves: each pod's block (1, ...), split further
    as the leaf is)."""
    pods = _pods(mesh)

    def one(p):
        if isinstance(p, shd.Sharded):
            spec = shd.P("pod" if pods > 1 else None, *shd._full_spec(
                p.spec, p.dim()))
            shards = [None if s is None else shd.set_spec(
                torch.zeros((1,) + tuple(s.shape), dtype=F32,
                            device=s.device), spec) for s in p.shards]
            return shd.Sharded(shards, spec, (pods,) + tuple(p.shape),
                               p.mesh)
        return torch.zeros((pods,) + tuple(p.shape), dtype=F32,
                           device=p.device)
    return tree_map(one, params)


def init_error(params, mesh=None):
    return init_accumulator(params, mesh)


def make_periodic_steps(api, mesh, opt_cfg: OptimizerConfig, *,
                        compress_int8: bool = False):
    """Returns (accum_step, sync_step).

    accum_step(params, acc, batch)            -> (acc, metrics)
    sync_step(params, opt_state, acc, err)    -> (params, opt, acc, err, stats)
    """
    if mesh is None:
        return _one_device(api, opt_cfg)
    has_pod = "pod" in mesh.axis_names

    def accum(comm):
        def run(params, acc, batch):
            if has_pod:   # the pod's rows; the pod a model of its own
                pods = comm.shape["pod"]
                batch = {k: shd.block(v, 0, pods, comm.axis_index("pod"))
                         for k, v in batch.items()}
                comm_in = comm.without("pod")
            else:
                comm_in = comm
            return steps.rank_loss(api, comm_in, params, batch), comm_in
        return run

    def accum_step(params, acc, batch):
        outs = mesh.run(lambda c: accum(c)(params, acc, batch))
        steps.mesh_backward(outs[0][1].size, [o[0] for o in outs])

        def add(comm):
            sub = comm.without("pod") if has_pod else comm
            grads = steps.take_grads(sub, params)
            with torch.no_grad():
                for a, g in zip(leaves(shd.local_tree(acc, comm.rank)),
                                grads):
                    a.add_(g.to(F32)[None])
            loss, metrics = outs[mesh.ranks.index(comm.rank)][0]
            out = dict(metrics, loss=loss)
            out = {k: v.detach() for k, v in out.items()}
            if has_pod:   # pods see different rows; replicate the metrics
                out = {k: comm.pmean(v, "pod") for k, v in out.items()}
            return out
        res = mesh.run(add)
        return acc, res[0]

    @torch.no_grad()
    def sync(comm, params, opt_state, acc, err):
        acc_l = leaves(shd.local_tree(acc, comm.rank))
        p_l = shd.local_tree(params, comm.rank)
        o_l = shd.local_tree(opt_state, comm.rank)
        zero = pod_dims(p_l, o_l["m"])
        if has_pod:
            if compress_int8:
                err_l = leaves(shd.local_tree(err, comm.rank))
                grads = []
                for a, e in zip(acc_l, err_l):
                    red, new_e = compress.allreduce_int8(a[0], e[0], "pod",
                                                         comm)
                    e.copy_(new_e[None])
                    grads.append(red)
                grads = scatter_grads(comm, grads, p_l, o_l["m"], zero,
                                      summed=True)
            else:
                # a ZeRO leaf's accumulator reduce-scattered to m's block
                grads = scatter_grads(comm, [
                    a[0] if d is not None else comm.psum(a, "pod")[0]
                    for a, d in zip(acc_l, zero)], p_l, o_l["m"], zero)
                grads = [g / comm.shape["pod"] for g in grads]
        else:
            # every slot of the leading axis holds the same reduced gradient
            grads = [a.sum(dim=0) / a.shape[0] for a in acc_l]
        grads = [g.to(p.dtype) for g, p in zip(grads, leaves(p_l))]
        _, new, stats = adamw_update(p_l, grads, o_l, opt_cfg, mesh=comm,
                                     zero=zero)
        for a in acc_l:
            a.zero_()
        return new["step"], stats

    def sync_step(params, opt_state, acc, err):
        res = mesh.run(lambda c: sync(c, params, opt_state, acc, err))
        return params, dict(opt_state, step=res[0][0]), acc, err, res[0][1]

    return accum_step, sync_step


def _one_device(api, opt_cfg: OptimizerConfig):
    """No mesh: one pod; the accumulator's leading axis is 1."""
    def accum_step(params, acc, batch):
        loss, metrics, grads = steps.loss_and_grads(api, params, batch)
        with torch.no_grad():
            for a, g in zip(leaves(acc), leaves(grads)):
                if g is not None:
                    a.add_(g.to(F32)[None])
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
