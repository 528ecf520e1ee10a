"""PyTorch + CUDA port of beluga_tpu, for one NVIDIA Hopper card.

The layout mirrors ``beluga_tpu/`` module for module; each module names the
function of the JAX package it ports.  The port imports ``torch`` and
numpy only.  Its entry points run on the card unless the caller passes
``device="cpu"``; on a CPU tensor every kernel wrapper runs its plain
PyTorch version instead of the CUDA kernel.

The package re-exports the JAX package's top-level API (``__all__``, the
same names from the port's modules of the same paths):

    from beluga_tpu_torch import AmclNode, make_likelihood_field_filter

Importing it builds no kernel: each wrapper builds its library at its first
launch on the card.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller says
    otherwise.  Raises when CUDA is asked for but absent — the port never
    falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


# the modules below import resolve_device from this package, so it comes first
from beluga_tpu_torch.lie import SE2, SE3, SO2, SO3, to_2d, to_3d  # noqa: E402
from beluga_tpu_torch.core.particles import ParticleSet, make_from_states  # noqa: E402
from beluga_tpu_torch.filters.amcl import (  # noqa: E402
    AmclModels,
    AmclParams,
    AmclState,
    Estimate,
    init_state,
    update,
)
from beluga_tpu_torch.filters.builders import (  # noqa: E402
    make_beam_filter,
    make_likelihood_field_filter,
    make_shared_scan_filter,
    update_map_ctx,
)
from beluga_tpu_torch.filters.ndt_builders import (  # noqa: E402
    make_ndt_filter_2d,
    make_ndt_filter_3d,
)
from beluga_tpu_torch.filters.vdb_builders import make_vdb_filter_3d  # noqa: E402
from beluga_tpu_torch.io.config import AmclNodeConfig, load_config  # noqa: E402
from beluga_tpu_torch.maps.ndt import load_ndt_hdf5, make_ndt_map  # noqa: E402
from beluga_tpu_torch.maps.occupancy import (  # noqa: E402
    OccupancyGrid,
    load_pgm_yaml,
    make_grid,
)
from beluga_tpu_torch.maps.voxel import (  # noqa: E402
    make_distance_grid,
    make_distance_grid_from_points,
)
from beluga_tpu_torch.node import AmclNode  # noqa: E402
from beluga_tpu_torch.ndt_node import NdtAmclNode, NdtAmclNode3D  # noqa: E402
from beluga_tpu_torch.parallel.fleet import (  # noqa: E402
    make_fleet_update,
    replicate,
    shard_fleet,
)

__version__ = "0.1.0"

__all__ = [
    "SE2", "SE3", "SO2", "SO3", "to_2d", "to_3d",
    "ParticleSet", "make_from_states",
    "AmclModels", "AmclParams", "AmclState", "Estimate", "init_state", "update",
    "make_likelihood_field_filter", "make_beam_filter", "make_shared_scan_filter", "update_map_ctx",
    "make_ndt_filter_2d", "make_ndt_filter_3d", "make_vdb_filter_3d",
    "AmclNodeConfig", "load_config",
    "load_ndt_hdf5", "make_ndt_map",
    "OccupancyGrid", "load_pgm_yaml", "make_grid",
    "make_distance_grid", "make_distance_grid_from_points",
    "AmclNode", "NdtAmclNode", "NdtAmclNode3D",
    "make_fleet_update", "replicate", "shard_fleet",
]
