"""Multi-rank runs: the fleet's weak scaling over ``torch.distributed``
(port of ``beluga_tpu/parallel/multihost.py``).

One rank on the card (one process, world size 1, ``nccl``)::

    python -m beluga_tpu_torch.parallel.multihost --particles 4096 --filters-per-device 8

One process per host, each on its first card, ``nccl`` through host 0's
address::

    python -m beluga_tpu_torch.parallel.multihost \\
        --coordinator 10.0.0.1:8476 --num-hosts 4 --host-id $ID

N ranks on CPU processes over ``gloo`` (no card needed; the analog of the
JAX package's ``xla_force_host_platform_device_count``)::

    python -m beluga_tpu_torch.parallel.multihost --simulate-devices 4

Rank 0 prints one JSON row per device count (``parallel/scaling.py``).
Several ranks on one host's cards are started by ``torchrun
--nproc-per-node N`` around a script that calls :func:`start_process_group`
with the rank and world size torchrun gives it, or by :func:`spawn_ranks`.

:func:`build_pod_mesh` lays the ranks out as ``(hosts, ranks per host)``
over ``("dp", "tp")``: the particle collectives stay within a host, and
only the fleet axis crosses hosts.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import pickle
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from beluga_tpu_torch import resolve_device


def start_process_group(device, rank: int, world: int, init_method: str,
                        timeout: float = 60.0) -> torch.device:
    """Join the default process group as ``rank`` of ``world``: ``nccl`` on
    ``"cuda"`` (the rank's card ``cuda:rank % cards`` made current first),
    ``gloo`` on ``"cpu"``; the backend follows the device and nothing falls
    back.  ``timeout`` (seconds) bounds every collective.  Returns the
    rank's device."""
    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    return device


def _rank_entry(rank: int, world: int, device: str, rundir: str, timeout: float) -> None:
    with open(os.path.join(rundir, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    dev = start_process_group(device, rank, world, f"file://{rundir}/store", timeout)
    try:
        result = fn(rank, world, dev, *args)
        if rank == 0:
            with open(os.path.join(rundir, "result.pkl"), "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, device=None, args: tuple = (), timeout: float = 60.0):
    """Run ``fn(rank, world, device, *args)`` on ``world`` new processes,
    each a rank of a process group on ``device``: ``"cuda"`` (``nccl``, one
    card a rank; raises here when CUDA is absent) unless the caller passes
    ``"cpu"`` (``gloo``).  The group starts through a file store in a
    temporary directory; returns what rank 0's ``fn`` returned.
    ``fn`` must be importable by name (a module-level function); ``args``
    and the result travel as pickles in that directory (tensors as copies).
    Raises when a rank fails or the whole run takes longer than ``timeout``
    seconds, which also bounds every collective; every process is stopped
    before this returns."""
    import torch.multiprocessing as mp

    device = resolve_device(device)
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        ctx = mp.start_processes(_rank_entry, args=(world, str(device), d, timeout),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks did not finish within {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        with open(os.path.join(d, "result.pkl"), "rb") as f:
            return pickle.load(f)


def build_pod_mesh(num_hosts: int, axis_names=("dp", "tp")):
    """The world's ranks as a ``(num_hosts, world / num_hosts)`` device
    mesh over ``axis_names``: hosts along ``dp``, each host's ranks along
    ``tp``, on the device type of the default group's backend."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if world % num_hosts:
        raise ValueError(f"{world} ranks do not split over {num_hosts} hosts")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (num_hosts, world // num_hosts),
                            mesh_dim_names=tuple(axis_names))


def pod_world(grid_size: int, device):
    """The pod run's map: a walled square of ``grid_size`` cells at 5 cm with
    24 blocks, from seed 0 (multihost.py:87-93); ``(models, ctx)`` of the
    likelihood-field filter on ``device``."""
    from beluga_tpu_torch.filters.builders import make_likelihood_field_filter
    from beluga_tpu_torch.maps.occupancy import OCCUPIED_VALUE, make_grid

    rng = np.random.default_rng(0)
    data = np.zeros((grid_size, grid_size), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = OCCUPIED_VALUE
    for _ in range(24):
        r, c = rng.integers(10, grid_size - 20, 2)
        data[r : r + 8, c : c + 8] = OCCUPIED_VALUE
    return make_likelihood_field_filter(make_grid(data, 0.05, device=device), device=device)


def _pod_rank(rank: int, world: int, device, opts: dict):
    from beluga_tpu_torch.filters.amcl import AmclParams
    from beluga_tpu_torch.parallel.scaling import measure_fleet_scaling

    models, ctx = pod_world(opts["grid_size"], device)
    params = AmclParams(max_particles=opts["particles"],
                        min_particles=max(opts["particles"] // 4, 8))
    return measure_fleet_scaling(models, ctx, params,
                                 filters_per_device=opts["filters_per_device"],
                                 num_beams=opts["beams"])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--coordinator", default=None,
                        help="host:port of host 0 (omit for one host)")
    parser.add_argument("--num-hosts", type=int, default=1)
    parser.add_argument("--host-id", type=int, default=0)
    parser.add_argument("--filters-per-device", type=int, default=8)
    parser.add_argument("--particles", type=int, default=4096)
    parser.add_argument("--beams", type=int, default=60)
    parser.add_argument("--grid-size", type=int, default=384)
    parser.add_argument("--simulate-devices", type=int, default=0,
                        help="run on N CPU processes over gloo (no card needed)")
    parser.add_argument("--timeout", type=float, default=600.0,
                        help="seconds the ranks may take in all, and any collective")
    args = parser.parse_args(argv)
    opts = vars(args)

    if args.simulate_devices:
        rows = spawn_ranks(_pod_rank, args.simulate_devices, "cpu", (opts,), args.timeout)
    else:
        if args.coordinator:
            rank, world, init = args.host_id, args.num_hosts, f"tcp://{args.coordinator}"
        else:
            rank, world = 0, 1
            store = tempfile.TemporaryDirectory()
            init = f"file://{store.name}/store"
        device = start_process_group("cuda", rank, world, init, args.timeout)
        try:
            rows = _pod_rank(rank, world, device, opts)
        finally:
            dist.destroy_process_group()
    if rows is not None:
        for row in rows:
            print(json.dumps(row))


if __name__ == "__main__":
    main()
