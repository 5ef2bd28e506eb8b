"""Phase-implementation registry: each variant field of ``BrainConfig``
resolves to a callable here, once, when a simulator is built.

``_DOMAINS`` lists the allowed names of every domain (the same table as the
JAX package's registry, copied so the port imports nothing of it);
``register_phase`` records an implementation under one of those names. A name
may be allowed but not yet ported: ``resolve`` then raises
``NotImplementedError`` naming the ROADMAP item that brings it.

This module is stdlib-only, so the config imports it without cycles.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

_DOMAINS: Dict[str, Tuple[str, ...]] = {
    "activity": ("reference", "fused"),
    "spikes": ("old", "new"),
    "connectivity": ("old", "new"),
    "traversal": ("reference", "fused"),
    "rate_exchange": ("dense", "sparse"),
    "tree": ("reference", "fused"),
    "apply": ("reference", "fused"),
}

CONFIG_FIELDS: Dict[str, str] = {
    "activity": "activity_impl",
    "spikes": "spike_alg",
    "connectivity": "connectivity_alg",
    "traversal": "connectivity_impl",
    "rate_exchange": "rate_exchange",
    "tree": "tree_impl",
    "apply": "apply_impl",
}

# allowed names the port does not run yet -> the ROADMAP item that brings them
_NOT_PORTED: Dict[Tuple[str, str], str] = {
    ("spikes", "old"): "ROADMAP.md Queue 1 item 9 (the paper's comparisons)",
    ("connectivity", "old"): "ROADMAP.md Queue 1 item 9 (the paper's "
                             "comparisons)",
    ("rate_exchange", "sparse"): "ROADMAP.md Queue 1 item 9 (the paper's "
                                 "comparisons)",
    ("tree", "fused"): "ROADMAP.md Queue 2 K3 morton_sort (next slice)",
    ("apply", "fused"): "ROADMAP.md Queue 2 K4 synapse_apply / K5 "
                        "route_build (next slice)",
}

_IMPLS: Dict[Tuple[str, str], Callable] = {}


def register_phase(domain: str, name: str):
    """Decorator: register ``fn`` as the ``name`` implementation of
    ``domain``. The (domain, name) pair must be declared in ``_DOMAINS``."""
    if domain not in _DOMAINS:
        raise ValueError(f"unknown phase domain {domain!r}; "
                         f"declared: {sorted(_DOMAINS)}")
    if name not in _DOMAINS[domain]:
        raise ValueError(f"implementation name {name!r} not declared for "
                         f"domain {domain!r}; declared: {_DOMAINS[domain]}")

    def deco(fn):
        _IMPLS[(domain, name)] = fn
        return fn
    return deco


def _bad_value(domain: str, name) -> ValueError:
    field = CONFIG_FIELDS[domain]
    opts = ", ".join(repr(v) for v in _DOMAINS[domain])
    return ValueError(f"unknown {field} {name!r}; allowed: {opts}")


def check_config(cfg) -> None:
    """Eager validation of all variant fields plus cross-field
    compatibility. Pure data lookup, no heavy imports."""
    for domain, field in CONFIG_FIELDS.items():
        value = getattr(cfg, field)
        if value not in _DOMAINS[domain]:
            raise _bad_value(domain, value)
    if cfg.activity_impl == "fused" and cfg.spike_alg != "new":
        raise ValueError(
            "activity_impl='fused' requires spike_alg='new' — the old "
            "algorithm exchanges spiked IDs every step, which cannot run "
            "inside the window kernel")


def ensure_loaded() -> None:
    """Import the modules that carry ``@register_phase`` decorators."""
    import repro_torch.sim.phases  # noqa: F401  (pulls in connectome.*)


def resolve(domain: str, name: str) -> Callable:
    """Name -> callable. Raises ``ValueError`` for a name the domain does
    not allow and ``NotImplementedError`` for one the port has not run yet."""
    ensure_loaded()
    if (domain, name) in _NOT_PORTED:
        raise NotImplementedError(
            f"{CONFIG_FIELDS[domain]}={name!r} is not ported yet; see "
            f"{_NOT_PORTED[(domain, name)]}")
    try:
        return _IMPLS[(domain, name)]
    except KeyError:
        raise _bad_value(domain, name) from None
