"""Mesh construction: the port of the JAX package's ``repro/launch/mesh.py``
(its TPU hardware table is not carried over).

``make_mesh(shape, axes)`` gives a ``dist.LocalMesh``: every rank in this
process on one device, behind the baton; where ``torch.distributed`` is
initialised with as many processes as the mesh has ranks, a
``dist.ProcessMesh`` (this process's rank). Building a mesh touches no
device.
"""
from __future__ import annotations

import math

from repro_torch import dist


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh's shape and axes: one pod 16x16 = 256 ranks
    ('data','model'); multi-pod 2x16x16 = 512 ('pod','data','model'). The
    shape only: (shape, axes)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def make_mesh(shape, axes):
    """A mesh of ``shape`` over ``axes``, e.g. ((2, 4), ('data', 'model'))."""
    import torch.distributed as tdist
    shape, axes = tuple(shape), tuple(axes)
    if tdist.is_available() and tdist.is_initialized() and \
            tdist.get_world_size() == math.prod(shape) > 1:
        return dist.ProcessMesh(shape, axes)
    return dist.LocalMesh(shape, axes)
