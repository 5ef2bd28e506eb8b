"""Carry a simulation state between the JAX reference and the port.

``state_from_numpy`` takes a reference ``BrainState`` pulled to the host
(``jax.device_get``: the same NamedTuple/dataclass tree with numpy leaves)
and builds the port's ``BrainState``; ``state_to_numpy`` goes the other way,
to plain nested dicts of numpy arrays. ``states_from_numpy`` splits a
reference global state of R ranks into one port state a rank, and
``states_to_numpy`` joins them back. Attribute access only, so this module
imports neither jax nor the reference package. The tests use it to inject a
reference state into the port phase by phase, ``scenario_from_reference``
to hand one protocol to both sides, and ``neuron_params_from_numpy`` to hand
both the same per-neuron constants.

For the LM stack, ``lm_params_from_numpy`` / ``lm_state_from_numpy`` take a
reference param tree or decode state pulled to the host (nested dicts and
lists of numpy arrays) and copy it leaf by leaf onto a device; a bf16 leaf
(``ml_dtypes.bfloat16`` there, recognised by its dtype's name) goes through
its 16 bits, so this module needs no ``ml_dtypes``. ``lm_params_to_numpy``
goes the other way, a bf16 leaf as its uint16 bits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.engine import BrainState
from repro_torch.device import resolve_device
from repro_torch.core.neuron import NeuronParams, NeuronState
from repro_torch.scenarios import protocol
from repro_torch.scenarios.populations import PopulationSpec
from repro_torch.scenarios.regions import Region
from repro_torch.telemetry.metrics import Metrics

_NEURON_FIELDS = NeuronState._fields


def _t(x, device):
    return None if x is None else torch.from_numpy(np.array(x)).to(device)


def state_from_numpy(tree, device=None) -> BrainState:
    """A reference state (numpy leaves) -> the port's BrainState on
    ``device`` (the card when None, as every entry point)."""
    device = resolve_device(device)
    neurons = NeuronState(*(_t(getattr(tree.neurons, f), device)
                            for f in _NEURON_FIELDS))
    s = tree.stats
    stats = Metrics(*({k: _t(v, device).to(torch.float32)
                       for k, v in dict(d).items()}
                      for d in (s.counters, s.per_chunk, s.hists, s.gauges)))
    return BrainState(
        neurons=neurons,
        out_edges=_t(tree.out_edges, device).to(torch.int32),
        in_edges=_t(tree.in_edges, device).to(torch.int32),
        positions=_t(tree.positions, device).to(torch.float32),
        rates_table=_t(tree.rates_table, device),
        subs=_t(tree.subs, device), rate_slots=_t(tree.rate_slots, device),
        remote_rates=_t(tree.remote_rates, device),
        chunk=int(np.asarray(tree.chunk)), stats=stats)


def _np(x):
    return None if x is None else x.detach().cpu().numpy()


def state_to_numpy(state: BrainState) -> dict:
    """The port's BrainState -> nested dicts of numpy arrays (the field
    names of the reference's state)."""
    s = state.stats
    return {
        "neurons": {f: _np(getattr(state.neurons, f))
                    for f in _NEURON_FIELDS},
        "out_edges": _np(state.out_edges), "in_edges": _np(state.in_edges),
        "positions": _np(state.positions),
        "rates_table": _np(state.rates_table), "subs": _np(state.subs),
        "rate_slots": _np(state.rate_slots),
        "remote_rates": _np(state.remote_rates),
        "chunk": np.int32(state.chunk),
        "stats": {name: {k: _np(v) for k, v in d.items()}
                  for name, d in (("counters", s.counters),
                                  ("per_chunk", s.per_chunk),
                                  ("hists", s.hists),
                                  ("gauges", s.gauges))},
    }


def states_from_numpy(tree, num_ranks: int, device=None) -> list:
    """A reference global state of ``num_ranks`` ranks (numpy leaves: the
    per-neuron rows of all ranks concatenated in rank order, the replicated
    rates table, the stats' leading per-rank axis) -> one port BrainState a
    rank (rank r holds rows r*n:(r+1)*n)."""
    return engine.split_state(state_from_numpy(tree, device), num_ranks)


def states_to_numpy(states) -> dict:
    """The ranks' port states -> the global state as nested dicts of numpy
    arrays (``state_to_numpy`` of ``engine.join_states``)."""
    return state_to_numpy(engine.join_states(states))


_EVENTS = {cls.__name__: cls for cls in (protocol.Stimulate, protocol.Lesion,
                                         protocol.Recover)}


def _copy(obj, cls):
    return cls(**{f.name: getattr(obj, f.name)
                  for f in dataclasses.fields(cls)})


def scenario_from_reference(obj) -> protocol.Scenario:
    """A reference ``Scenario`` -> the port's, field by field (populations,
    regions and events by their class names and fields)."""
    return protocol.Scenario(
        name=obj.name,
        populations=tuple(_copy(p, PopulationSpec) for p in obj.populations),
        regions=tuple(_copy(r, Region) for r in obj.regions),
        events=tuple(_copy(e, _EVENTS[type(e).__name__])
                     for e in obj.events),
        num_chunks=obj.num_chunks)


def neuron_params_from_numpy(obj, device=None) -> NeuronParams:
    """A reference ``NeuronParams`` or population table (fields izh_a ..
    izh_d, growth_rate, target_calcium; numpy arrays or scalars) -> the
    port's ``NeuronParams``: a scalar stays a Python float, an array becomes
    a float32 tensor on ``device`` (the card when None, as every entry
    point)."""
    device = resolve_device(device)
    def conv(x):
        if np.ndim(x) == 0:
            return float(x)
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)

    return NeuronParams(*(conv(getattr(obj, f)) for f in NeuronParams._fields))


def _leaf_from_numpy(x, device):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        bits = np.array(a).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def lm_params_from_numpy(tree, device=None) -> dict:
    """A reference LM param tree (numpy leaves) -> the port's params on
    ``device`` (the card when None, as every entry point), the same keys."""
    device = resolve_device(device)
    return _tree_map(lambda x: _leaf_from_numpy(x, device), tree)


def lm_state_from_numpy(tree, device=None) -> dict:
    """A reference decode state ({"pos", "layers"}, numpy leaves) -> the
    port's on ``device``; ``pos`` a 0-d int32 tensor."""
    device = resolve_device(device)
    out = _tree_map(lambda x: _leaf_from_numpy(x, device), tree)
    out["pos"] = out["pos"].to(torch.int32).reshape(())
    return out


def _leaf_to_numpy(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def lm_params_to_numpy(tree) -> dict:
    """The port's params (or decode state) -> nested dicts and lists of
    numpy arrays (a bf16 leaf as its uint16 bits)."""
    return _tree_map(_leaf_to_numpy, tree)


def lm_opt_state_from_numpy(tree, device=None) -> dict:
    """A reference AdamW state ({"m", "v", "step"}, numpy leaves) -> the
    port's on ``device``; ``step`` a 0-d int32 tensor."""
    device = resolve_device(device)
    return {"m": lm_params_from_numpy(tree["m"], device),
            "v": lm_params_from_numpy(tree["v"], device),
            "step": torch.tensor(int(np.asarray(tree["step"])),
                                 dtype=torch.int32, device=device)}


def lm_opt_state_to_numpy(state) -> dict:
    """The port's AdamW state -> {"m", "v", "step"} of numpy arrays (bf16
    leaves as their uint16 bits, ``step`` an int32 scalar)."""
    return {"m": lm_params_to_numpy(state["m"]),
            "v": lm_params_to_numpy(state["v"]),
            "step": np.asarray(int(state["step"]), np.int32)}
