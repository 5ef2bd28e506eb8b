"""Faults planted in the program's timed path, to show that ``correct``
comes out false: the CPU tests plant them at small sizes, and
``control.py --fault`` at a cell's own size on the card. Each is a context
manager that patches one function of the program and restores it.

Brain: ``unchanged`` (a chunk returns its state, only the chunk counter
advanced), ``half`` (the activity window computed for the first half of
the neurons, the rest keeping their state), ``answer`` (one accepted
partner's gid altered where the accept answers). LM training:
``unchanged`` (the update leaves params, m and v as they were), ``half``
(the loss's mean over the first half of the positions only), ``answer``
(one leaf's gradient, the MLP's up projection, doubled where the backward
produces it). The exchange between chips is no fault of a one-chip cell.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, name, fn):
    real = getattr(module, name)
    setattr(module, name, fn(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def brain_unchanged():
    from repro_torch.sim import phases
    return _patched(phases, "sim_chunk", lambda real: (
        lambda state, ctx: state._replace(chunk=state.chunk + 1)))


def brain_half():
    from repro_torch.sim import phases

    def wrap(real):
        def half(state, ctx):
            new = real(state, ctx)
            n = state.neurons.v.shape[0] // 2
            keep = [x.clone() for x in new.neurons]
            for k, old in zip(keep, state.neurons):
                k[n:] = old[n:]
            return new._replace(neurons=type(new.neurons)(*keep))
        return half
    return _patched(phases, "activity_phase", wrap)


def brain_answer():
    from repro_torch.connectome import synapses

    def wrap(real):
        def altered(out_edges, tgt_gid, accept):
            import torch
            first = torch.argmax(accept.to(torch.int32))
            tgt = tgt_gid.clone()
            tgt[first] = (tgt[first] + 1) % out_edges.shape[0]
            return real(out_edges, tgt, accept)
        return altered
    return _patched(synapses, "add_out_edges", wrap)


def lm_unchanged():
    from repro_torch.launch import steps
    return _patched(steps, "adamw_update", lambda real: (
        lambda params, grads, opt, cfg, **kw:
        (params, dict(opt, step=opt["step"] + 1), {})))


def lm_half():
    from repro_torch.models import transformer

    def wrap(real):
        def half(logits, labels, mask=None):
            s = logits.shape[1] // 2
            return real(logits[:, :s], labels[:, :s], mask)
        return half
    return _patched(transformer, "cross_entropy", wrap)


def lm_answer():
    from repro_torch.launch import steps

    def wrap(real):
        def altered(api, params, batch):
            loss, metrics, grads = real(api, params, batch)
            mlp = grads["layers_stacked"]["mlp"]
            mlp["w_up"] = mlp["w_up"] * 2
            return loss, metrics, grads
        return altered
    return _patched(steps, "loss_and_grads", wrap)


FAULTS = {"brain": {"unchanged": brain_unchanged, "half": brain_half,
                    "answer": brain_answer},
          "train": {"unchanged": lm_unchanged, "half": lm_half,
                    "answer": lm_answer}}
