"""The fleet's weak-scaling sweep over ``torch.distributed`` ranks (port of
``beluga_tpu/parallel/scaling.py``).

BASELINE.md asks for filters/s scaling efficiency at 1 chip, 1 host and N
>= 2 hosts.  The sweep runs the same fleet on the first 1, 2, 4, ... ranks
(``filters_per_device × d`` filters on d ranks, a ``(d, 1)`` mesh over
``("dp", "tp")``) while the other ranks wait at a barrier.  On one card it
gives the one-rank row; CPU ranks over ``gloo`` run the same code in the
tests.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from beluga_tpu_torch.filters.amcl import AmclParams, host_pose, init_fleet_state
from beluga_tpu_torch.lie import SE2
from beluga_tpu_torch.parallel.fleet import make_fleet_update, replicate, shard_fleet


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_fleet_scaling(models, ctx, params: AmclParams, filters_per_device: int = 8,
                          num_beams: int = 40, iters: int = 10, device_counts=None,
                          mesh=None):
    """Weak-scaling sweep: ``B = filters_per_device × d`` filters on the
    first ``d`` ranks for each ``d`` of ``device_counts`` (default 1, 2, 4,
    ... up to the world size).  Every rank of the default group must call
    it, with ``models`` and ``ctx`` on its device; the ranks are taken in
    the order of ``mesh`` (default: rank order).

    Each count times ``iters`` fleet updates after two warm-up ones, from a
    barrier of its ``d`` ranks (and ``torch.cuda.synchronize`` on the card)
    to another.  Rank 0 returns the rows ``{devices, filters, steps_per_s,
    filters_per_s, efficiency}``, the efficiency relative to the first
    row's filters/s per rank; the other ranks return ``None``."""
    from torch.distributed.device_mesh import DeviceMesh

    world, me = dist.get_world_size(), dist.get_rank()
    order = (list(range(world)) if mesh is None
             else [int(r) for r in mesh.mesh.flatten().tolist()])
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= world]
    device = ctx["grid"].data.device
    device_type = "cuda" if device.type == "cuda" else "cpu"
    rng = np.random.default_rng(0)
    rows, base_rate = [], None
    for d in device_counts:
        ranks = order[:d]
        # every rank takes part in making the group and the mesh's groups
        group = dist.new_group(ranks)
        sub = DeviceMesh(device_type, torch.tensor(ranks).reshape(d, 1),
                         mesh_dim_names=("dp", "tp"))
        batch = filters_per_device * d
        points = torch.as_tensor(rng.uniform(-2, 2, (batch, num_beams, 2)), dtype=torch.float32)
        if me in ranks:
            gen = torch.Generator(device=device)
            gen.manual_seed(1)
            state = init_fleet_state(gen, batch, host_pose(3.0, 3.0, 0.0), np.eye(3) * 0.2,
                                     params, device=device)
            state = shard_fleet(sub, state)
            rctx = replicate(sub, ctx)
            at, b = sub.get_local_rank("dp"), filters_per_device
            pts = points[at * b:(at + 1) * b].to(device)
            masks = torch.ones((b, num_beams), dtype=torch.bool, device=device)
            odoms = [SE2.from_xytheta(np.full(b, 0.3 * i), np.zeros(b), np.zeros(b),
                                      device="cpu") for i in range(1, 5)]
            fleet_update = make_fleet_update(params, models, sub)
            for i in range(2):
                state, _ = fleet_update(rctx, state, odoms[i % 4], pts, masks)
            _sync(device)
            dist.barrier(group=group)
            t0 = time.perf_counter()
            for i in range(iters):
                state, _ = fleet_update(rctx, state, odoms[(2 + i) % 4], pts, masks)
            _sync(device)
            dist.barrier(group=group)
            dt = (time.perf_counter() - t0) / iters
            filters_per_s = batch / dt
            per_rank = filters_per_s / d
            if base_rate is None:
                base_rate = per_rank
            rows.append({"devices": d, "filters": batch, "steps_per_s": 1.0 / dt,
                         "filters_per_s": filters_per_s, "efficiency": per_rank / base_rate})
        dist.barrier()
    return rows if me == order[0] else None
