"""3D localization filter over a dense distance voxel map (port of
``beluga_tpu/filters/vdb_builders.py``; BASELINE config #4).

The VDB likelihood-field model (models/sensor/vdb_likelihood.py) in the
core update with SE3 particles: the flattened-3D diff-drive, the SE3
spatial hash, estimate and on-motion gate, and recovery states drawn about
the current estimate (a distance volume has no free cells; the reference
3D nodes recover the same way).

Where the reference builds the code table only on a TPU
(``vdb_builders.py:47``), the port builds it whenever ``voxel_size_hint``
is given, so that on the card every distance lookup runs kernel B11 (on
the CPU its plain version).
"""

from __future__ import annotations

import torch

from beluga_tpu_torch.filters.amcl import AmclModels, se3_motion_delta
from beluga_tpu_torch.filters.ndt_builders import se3_estimate, se3_hash_state, se3_recovery
from beluga_tpu_torch.maps.voxel import DistanceGrid3, make_distance_codes
from beluga_tpu_torch.models.motion.differential_drive import (
    DifferentialDriveParams,
    diff_drive_propagate_3d,
)
from beluga_tpu_torch.models.sensor.vdb_likelihood import (
    VdbLikelihoodFieldParams,
    vdb_likelihood_weights,
)


def make_vdb_filter_3d(grid: DistanceGrid3,
                       vdb_params: VdbLikelihoodFieldParams = VdbLikelihoodFieldParams(),
                       motion_params: DifferentialDriveParams = DifferentialDriveParams(),
                       voxel_size_hint: float | None = None):
    """``(models, ctx)`` of the SE3 VDB likelihood-field filter on the
    grid's device.  With ``voxel_size_hint`` (the voxel size the grid was
    built with) the ctx holds the code table ``vdb_codes`` and lookups go
    through kernel B11; without it, through a gather of the volume.
    Initialize its state with ``odom_identity=SE3.identity()``."""
    ctx = {"vdb_grid": grid}
    if voxel_size_hint is not None:
        ctx["vdb_codes"] = make_distance_codes(grid, voxel_size_hint,
                                               vdb_params.max_obstacle_distance)

    def log_weight(ctx, states, points, point_mask):
        return torch.log(vdb_likelihood_weights(vdb_params, ctx["vdb_grid"], states, points,
                                                point_mask, codes_book=ctx.get("vdb_codes")))

    def random_state(ctx, generator, n, particles):
        return se3_recovery(generator, n, particles)

    def propagate(ctx, z, states, pose, prev):
        return diff_drive_propagate_3d(motion_params, z, states, pose, prev)

    models = AmclModels(propagate=propagate, log_weight=log_weight, random_state=random_state,
                        hash_state=se3_hash_state, estimate=se3_estimate,
                        motion_delta=se3_motion_delta)
    return models, ctx
