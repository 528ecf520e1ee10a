"""One run of one cell: set-up, the timed window of ticks, the check of
what the window produced against the plain reference, and the metrics.

Everything that belongs to a cell is found by name from
``BENCHMARK.json``: the cell's configuration ``mclbench/configs/<config>.json``
(its ``driver`` names ``mclbench/drivers/<driver>.py``, its ``reference``
names ``mclbench/reference/<reference>.py``), its traffic
``mclbench/traffic/<mix>.json`` (read by ``generator.py``), its sensor
model ``mclbench/sensors/<sensor>.py`` and each per-layer metric's reader
``mclbench/metrics/<name>.py``.  A cell, a mix, a
configuration or a metric is added by adding files and entries, never by
editing these.

A tick is one simulator step of every robot the driver serves, a closed
loop: the scans in host memory (where a server receives them, one for each
of the lattice's poses) are copied to the card in one transfer with the
robots' lattice points, each robot's scan is picked there, the driver's
update is called once on the robots' odometry, and every robot's estimate
is read back; the next tick starts when the estimate is on the host.  A
driver may serve one filter (``robots`` 1) as well as a fleet.

The check comes from the configuration's reference: its own ``check``
where it defines one, else ``reference/common.py:check``, with the same
signature, ``check(records, inputs, sensor, config, device, low=False,
seed=0) -> dict``, returning some of ``common.NUMBERS``, each held to the
configuration's ``limits``.  What a driver's records hold is agreed
between that driver and that check.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from mclbench import generator, world
from mclbench.reference import common

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"
WARMUP_TICKS = 3  # ticks 0-2 run in set-up: the forced first update and two of the traffic
ARMED_TICKS, ARMED_SPAN, ARMED_ROBOTS = 3, 24, 16  # the check's ticks and robots
TRACE_FROM, TRACE_TICKS = ARMED_SPAN, 24  # the traced ticks of a --trace 1 run
GATE_AFTER = 2  # ticks before the accuracy gate holds (tick index of the run)
FORBIDDEN = ("jax", "jaxlib", "flax", "beluga_tpu")


def load(path: Path) -> dict:
    return json.loads(path.read_text())


def cell_files(name: str) -> tuple[dict, dict, dict, dict]:
    """``(benchmark, cell, config, mix)`` of the cell ``name``."""
    bench = load(BENCHMARK)
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no cell {name!r} in {BENCHMARK.name}")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load(HERE.parent / entry["file"])
    return bench, cell, config, generator.load_mix(cell["traffic"])


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class TraceContext:
    """What a per-layer metric's reader gets."""

    trace: object
    config: dict
    robots: int
    particles: int
    sensor_work: list = dataclasses.field(default_factory=list)  # (ops, bytes) a traced tick


def end_to_end(tick_s: list, updates: int, window_s: float, setup_s: float) -> dict:
    """The end-to-end metrics of a window: the particle-updates of every
    tick over the window's seconds (copies and readbacks in it), the 95th
    percentile of every tick's seconds (linear between order statistics),
    and the set-up."""
    return {"particle_updates_per_s": updates / window_s,
            "tick_ms_p95": float(np.percentile(np.asarray(tick_s) * 1e3, 95)),
            "setup_s": setup_s}


def card(device) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    import subprocess

    limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60).stdout.strip()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "power_limit": limit.splitlines()[0] if limit else "not read"}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             started: float | None = None, robots: int | None = None,
             particles: int | None = None, fault=None, control: bool = False,
             log=lambda line: print(line, file=sys.stderr)) -> dict:
    """One run of cell ``name``; returns the result line's object.

    ``robots``, ``particles`` shrink the configuration (the tests' small
    fleets); ``fault`` wraps the fleet update (the tests' broken paths);
    ``control`` adds the control's numbers to the result
    (``"control_checks"``)."""
    started = time.time() if started is None else started
    device = torch.device(device)
    bench, _, config, mix = cell_files(name)
    robots = robots or config["robots"]
    particles = particles or config["particles"]
    mcfg = config["map"]
    scan = config["scan"]

    # -- set-up: the world, the traffic, the program, warm-up ----------------------
    phases = {"start": time.time() - started}
    data = world.tracking_arena(mcfg["grid"], mcfg["resolution"])
    lattice = world.lattice_poses(mix["lattice"], mcfg["grid"], mcfg["resolution"],
                                  mix["radius"])
    pts_dev, mask_dev = world.cast_scans(data, mcfg["resolution"], lattice, scan["beams"],
                                         scan["max_range"], device)
    # the scans in host memory, pinned on the card, so that each copy is one transfer
    pin = device.type == "cuda"
    points_h, mask_h = pts_dev.cpu(), mask_dev.cpu()
    if pin:
        points_h, mask_h = points_h.pin_memory(), mask_h.pin_memory()
    del pts_dev, mask_dev
    idx_h = torch.empty(robots, dtype=torch.int64, pin_memory=pin)
    poses32 = torch.as_tensor(lattice, dtype=torch.float32)
    phases["world"] = time.time() - started

    ticks = generator.Ticks(mix, robots, seed)
    first = ticks.next()
    driver = importlib.import_module(f"mclbench.drivers.{config['driver']}")
    prog = driver.Fleet(config, data, lattice[first.idx], device, seed, robots, particles)
    if fault is not None:
        prog.update = fault(prog.update)
    prog.reserve()
    rng = np.random.default_rng([seed, 1])
    armed_at = sorted((WARMUP_TICKS + rng.choice(ARMED_SPAN, ARMED_TICKS, replace=False)).tolist())
    rows = torch.as_tensor(np.sort(rng.choice(robots, min(ARMED_ROBOTS, robots),
                                              replace=False)), device=device)
    phases["program"] = time.time() - started

    def span(label):
        return prog._range(label)

    def one_tick(tick):
        with span("tick"):
            t0 = time.perf_counter()
            with span("tick.copy_in"):
                idx_h.copy_(torch.from_numpy(tick.idx))  # the last tick's copy has ended
                idx = idx_h.to(device, non_blocking=True)
                pts = points_h.to(device, non_blocking=True).index_select(0, idx)
                msk = mask_h.to(device, non_blocking=True).index_select(0, idx)
                odom = poses32[torch.from_numpy(tick.idx)]
            pose, valid = prog.step(odom, pts, msk)
            t1 = time.perf_counter()
        return t1 - t0, t1, pose, valid

    poses_log = []  # (tick, estimates) of every tick from the gate's start
    _, _, pose, _ = one_tick(first)
    poses_log.append((first, pose))
    for _ in range(WARMUP_TICKS - 1):
        tick = ticks.next()
        poses_log.append((tick, one_tick(tick)[2]))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    phases["warm-up"] = time.time() - started
    log("set-up s since the process started, at the end of each phase: "
        + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))
    # what set-up made stays; the collector's full passes skip it in the window
    gc.collect()
    gc.freeze()

    # -- the window --------------------------------------------------------------------
    records, tick_s, updates = [], [], 0
    profiler = trace_dir = None
    t_start = time.time()
    setup_s = t_start - started
    window_start = time.perf_counter()
    end = window_start
    while True:
        tick = ticks.next()
        k = tick.t - WARMUP_TICKS
        if trace and k == TRACE_FROM:
            profiler, trace_dir = _start_profiler(device)
            prog.ranges = True
        if tick.t in armed_at:
            rec = prog.arm(rows, whole=tick.t == armed_at[-1])
            rec["tick"] = tick
        dt, end, pose, valid = one_tick(tick)
        tick_s.append(dt)
        updates += int(tick.moved.sum()) * particles
        poses_log.append((tick, pose))
        if tick.t in armed_at:
            rec["est"] = pose
            records.append(rec)
        if profiler is not None and k == TRACE_FROM + TRACE_TICKS - 1:
            prog.ranges = False
            profiler.stop()
            profiler_done = profiler
            profiler = None
        if end - window_start >= seconds and len(records) == ARMED_TICKS and (
                not trace or k >= TRACE_FROM + TRACE_TICKS - 1):
            break
    window_s = end - window_start
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    else:
        peak = 0
    attempted = failed = 0
    gate_m, gate_rad = config["gate"]["position_m"], math.radians(config["gate"]["yaw_deg"])
    for tick, est in poses_log[WARMUP_TICKS:]:
        truth = lattice[tick.idx]
        d = est - truth
        err_yaw = np.abs(np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2])))
        miss = (np.hypot(d[:, 0], d[:, 1]) >= gate_m) | (err_yaw >= gate_rad)
        attempted += len(miss)
        if tick.t >= GATE_AFTER:
            failed += int(miss.sum())

    # -- the check, on the program's state freed ---------------------------------
    gc.unfreeze()
    prog.close()
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.time()
    ref = importlib.import_module(f"mclbench.reference.{config['reference']}")
    sensor = ref.Sensor(data, config, device)
    inputs = {"poses": poses32, "points": points_h, "mask": mask_h}
    check = getattr(ref, "check", common.check)
    numbers = check(records, inputs, sensor, config, device)
    limits = config["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    log(f"check: {time.time() - t_check:.3f} s after the window")

    result = {"correct": correct, "attempted": attempted, "failed": failed}
    dev = card(device)
    dev["memory_peak_bytes"] = int(peak)
    if not trace:
        values = end_to_end(tick_s, updates, window_s, setup_s)
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        result["metrics"] = {m: {"value": v, "unit": units[m]} for m, v in values.items()
                             if any(e["name"] == m and _applies(e, name)
                                    for e in bench["end_to_end"])}
        log(f"window: {len(tick_s)} ticks in {window_s} s, {updates} particle-updates")
        q = np.array_split(np.asarray(tick_s) * 1e3, 4)
        log("tick ms by quarter of the window (median, max): "
            + "; ".join(f"{np.median(a):.3f}, {a.max():.3f}" for a in q if len(a)))
    else:
        tr = _read_trace(profiler_done, trace_dir)
        ctx = _trace_context(tr, config, robots, particles, data, points_h, mask_h, lattice,
                             poses_log)
        result["metrics"] = {}
        for m in bench["per_layer"]:
            if not _applies(m, name):
                continue
            reader = importlib.import_module(f"mclbench.metrics.{m['name'].replace('.', '_')}")
            v = reader.read(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = tr.busy_us() * 1e-6
        dev["window_s"] = tr.window_us() * 1e-6
        result["breakdown"] = tr.breakdown()
        log(f"traced: {tr.ticks} ticks, {len(tr.kernels)} kernels, trace in {trace_dir}")
        log("host ms a tick by span: " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(tr.host_ms_by_span().items())))
    result["device"] = dev
    if control:
        low = check(records, inputs, sensor, config, device, low=True, seed=seed)
        result["control_checks"] = {k: {"value": v, "limit": limits[k]} for k, v in low.items()}
    for k, c in checks.items():
        log(f"check {k}: {c['value']} (limit {c['limit']})")
    result["checks"] = checks
    # after the window, the metric readers, the reference and its checks
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: {', '.join(found)}")
    return result


def _start_profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    root = os.environ.get("TMPDIR") or tempfile.gettempdir()
    trace_dir = tempfile.mkdtemp(prefix="mclbench-trace-", dir=root)
    prof = profile(activities=acts)
    prof.start()
    return prof, trace_dir


def _read_trace(prof, trace_dir):
    from mclbench.trace import Trace

    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    return Trace.load(path)


def _trace_context(tr, config, robots, particles, data, points_h, mask_h, lattice, poses_log):
    """The readers' inputs: the sensor's work in each traced tick, as the
    sensor's own module counts it."""
    traced = [t for t, _ in poses_log
              if TRACE_FROM <= t.t - WARMUP_TICKS < TRACE_FROM + TRACE_TICKS]
    sensor = importlib.import_module(f"mclbench.sensors.{config['sensor']}")
    work = sensor.work(config, data, points_h, mask_h, lattice, particles)
    return TraceContext(tr, config, robots, particles, [work(t.idx) for t in traced])
