"""Filter fleets: B independent AMCL filters batched along a leading axis
(port of ``beluga_tpu/parallel/fleet.py:make_fleet_update``).

The JAX package ``vmap``s the single-filter update; the port's update
(filters/amcl.py) already takes leading filter axes, so a fleet is the
same update on a state from :func:`filters.amcl.init_fleet_state` (or
``init_state`` with ``[B, N]`` states).  Its gates are per filter: host
numpy ``bool[B]`` from the odometry the caller holds, device selects for
the ESS gate, and a filter that is gated out keeps its particles, Thrun
state, counters and control window bit for bit.  One ``torch.Generator``
serves the fleet and draws ``[B, ...]``, so filters draw independently.

``fleet_state_sharding``, ``shard_fleet`` and ``replicate`` place a fleet
on a device mesh; they wait for the multi-GPU slice, ROADMAP A6.
"""

from __future__ import annotations

import functools

from beluga_tpu_torch.filters.amcl import AmclModels, AmclParams, update


def make_fleet_update(params: AmclParams, models: AmclModels):
    """Returns ``fleet_update(ctx, states, odoms, points, masks, draws=None,
    sort_now=None) -> (states, estimates)`` over a batched ``AmclState``:
    ``odoms`` an SE2 ``[B]`` on the host, ``points`` ``f32[B, nb, 2]`` and
    ``masks`` ``bool[B, nb]`` on the particles' device; ``ctx`` (the map)
    is shared.  Estimates are ``[B]`` poses, ``[B, 3, 3]`` covariances and
    ``valid`` as numpy ``bool[B]``."""
    return functools.partial(update, params, models)
