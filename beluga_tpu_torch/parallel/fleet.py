"""Filter fleets: B independent AMCL filters batched along a leading axis
(port of ``beluga_tpu/parallel/fleet.py``).

The JAX package ``vmap``s the single-filter update; the port's update
(filters/amcl.py) already takes leading filter axes, so a fleet is the
same update on a state from :func:`filters.amcl.init_fleet_state` (or
``init_state`` with ``[B, N]`` states).  Its gates are per filter: host
numpy ``bool[B]`` from the odometry the caller holds, device selects for
the ESS gate, and a filter that is gated out keeps its particles, Thrun
state, counters and control window bit for bit.  One ``torch.Generator``
serves the fleet and draws ``[B, ...]``, so filters draw independently.

On a ``("dp", "tp")`` device mesh of ``torch.distributed`` ranks
(:func:`fleet_state_sharding`, :func:`shard_fleet`, :func:`replicate`),
``dp`` splits the filters and ``tp`` each filter's particles: every rank
holds its ``[B / dp, N / tp]`` block.  ``dp`` needs no collective, so at
``tp == 1`` each rank runs the dense update on its block; past it the
fleet update is the sharded update of ``parallel/mega.py`` over the rank's
``tp`` group, which is how the port does what GSPMD does for the JAX
fleet.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from beluga_tpu_torch.filters.amcl import AmclModels, AmclParams, AmclState, update
from beluga_tpu_torch.parallel.mega import make_mega_update
from beluga_tpu_torch.parallel.placement import (
    axis_size,
    broadcast_,
    place,
    shard_generators,
    state_sharding,
)


def make_fleet_update(params: AmclParams, models: AmclModels, mesh=None):
    """Returns ``fleet_update(ctx, states, odoms, points, masks, draws=None,
    sort_now=None) -> (states, estimates)`` over a batched ``AmclState``:
    ``odoms`` an SE2 ``[B]`` on the host, ``points`` ``f32[B, nb, 2]`` and
    ``masks`` ``bool[B, nb]`` on the particles' device; ``ctx`` (the map)
    is shared.  Estimates are ``[B]`` poses, ``[B, 3, 3]`` covariances and
    ``valid`` as numpy ``bool[B]``.  With a ``mesh`` whose ``"tp"``
    dimension has more than one rank, the update is
    :func:`parallel.mega.make_mega_update` over it, on each rank's block
    from :func:`shard_fleet`, its arguments the rank's ``[B / dp]``."""
    if mesh is not None and "tp" in mesh.mesh_dim_names and axis_size(mesh, "tp") > 1:
        return make_mega_update(params, models, mesh, "tp")
    return functools.partial(update, params, models)


def fleet_state_sharding(mesh, state: AmclState) -> AmclState:
    """The placement tree of a batched ``AmclState`` on ``mesh``: each leaf
    names, per axis, the mesh dimension that splits it.  Particle leaves
    ``[B, N, ...]`` are ``("dp", "tp", None...)``, per-filter leaves
    ``("dp", None...)``, the host gates and odometry memory included; the
    generator is ``None``, since each rank draws from its own."""
    return state_sharding(mesh, state)


def shard_fleet(mesh, state: AmclState) -> AmclState:
    """Each rank's ``[B / dp, N / tp]`` block of a fleet's state (the same
    on every rank, or at least on mesh coordinate ``(0, 0)``, whose bits
    every rank takes), on the rank's device, with its own generator
    (seeded from the fleet's seed and the rank's coordinate), and at
    ``tp > 1`` the shared generator of its ``tp`` group."""
    placed = place(state, fleet_state_sharding(mesh, state), mesh)
    shared = "tp" in mesh.mesh_dim_names and axis_size(mesh, "tp") > 1
    return placed._replace(generator=shard_generators(mesh, state.generator, shared))


def replicate(mesh, tree: Any) -> Any:
    """``tree`` (the map ctx: dicts, dataclasses, tuples and lists of
    tensors) with every tensor on the mesh's device overwritten, in place,
    by the bits of mesh coordinate ``(0, ...)``, so that all ranks hold the
    same map; other leaves are left as they are.  Returns ``tree``."""
    if isinstance(tree, torch.Tensor):
        if tree.device.type == mesh.device_type:
            broadcast_(tree, mesh)
    elif isinstance(tree, dict):
        for value in tree.values():
            replicate(mesh, value)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            replicate(mesh, getattr(tree, f.name))
    elif isinstance(tree, (tuple, list)):
        for value in tree:
            replicate(mesh, value)
    return tree
