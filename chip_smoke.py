#!/usr/bin/env python3
"""Build and drive the PyTorch + CUDA port (``beluga_tpu_torch``) on one
NVIDIA GPU, and fail unless it is right.

    python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:

1. device: the card's name and power limit;
2. build: every ``beluga_tpu_torch/csrc/*.cu`` with nvcc, one process per
   source, started together;
3. kernels: each kernel's wrapper on card tensors at the shapes the main
   path gives it (2000 particles x 60 beams) and at 262144, held against
   its plain PyTorch version on the same inputs and timed beside it;
4. node: ``AmclNode`` at nav2 defaults tracks the synthetic arena's circle
   for 50 scans; every valid estimate must lie within 0.9 m / 30 degrees
   of the truth, and both kernels must have been launched;
5. large filter: one 262144-particle filter (systematic resampling, KLD
   down to 65536) through ``filters.amcl.update`` for 12 scans, same gate.

The line before the last two is the ``kernels`` JSON; the line before the
last is ``nvidia-smi``'s name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32
# operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# float32 operations per unmasked (particle, beam) in kernel B1: 8 for the
# endpoint transform, 2 divisions, 2 for the cube, 1 for the sum
B1_OPS_PER_BEAM = 13

GATE_POS_M = 0.9  # tests/test_system.py:44-45
GATE_YAW_RAD = math.radians(30.0)
GRID, RES, BEAMS = 384, 0.05, 60
NODE_SCANS = 50
LARGE_N, LARGE_MIN, LARGE_SCANS = 262144, 65536, 12


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events),
    after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def yaw_error(a: float, b: float) -> float:
    return abs(math.atan2(math.sin(a - b), math.cos(a - b)))


# -- phase 3: kernels against their plain versions ---------------------------


def workload(n: int, dev):
    """Field code table, particles and one scan of the tracking workload:
    90% of the particles in a cloud about the first pose, 10% spread over
    a box larger than the map (some endpoints fall off the map)."""
    from beluga_tpu_torch.filters.builders import make_likelihood_field_filter
    from beluga_tpu_torch.io import synthetic
    from beluga_tpu_torch.io.config import AmclNodeConfig
    from beluga_tpu_torch.lie import SE2
    from beluga_tpu_torch.maps.occupancy import make_grid

    data = synthetic.tracking_arena(GRID, RES)
    xs, ys, yaws = synthetic.circle_trajectory(1, GRID, RES)
    pts, mask = synthetic.simulate_scans(data, RES, xs, ys, yaws, BEAMS)
    _, ctx = make_likelihood_field_filter(
        make_grid(data, RES, device=dev),
        AmclNodeConfig().likelihood_field_params(), device=dev,
    )
    rng = np.random.default_rng(n)
    near = int(n * 0.9)
    px = np.concatenate([rng.normal(xs[0], 0.5, near), rng.uniform(-2, GRID * RES + 2, n - near)])
    py = np.concatenate([rng.normal(ys[0], 0.5, near), rng.uniform(-2, GRID * RES + 2, n - near)])
    pth = np.concatenate([rng.normal(yaws[0], 0.26, near), rng.uniform(-np.pi, np.pi, n - near)])
    states = SE2.from_xytheta(px.astype(np.float32), py.astype(np.float32),
                              pth.astype(np.float32), device=dev)
    tf = ctx["field"].world_to_field @ states
    return dict(
        ctx=ctx,
        tf=[t.contiguous() for t in (tf.x, tf.y, tf.rot.cos, tf.rot.sin)],
        states=states,
        points=torch.as_tensor(pts[0]).to(dev),
        mask=torch.as_tensor(mask[0]).to(dev),
    )


def check_reweight(n: int, dev, iters: int) -> dict:
    from beluga_tpu_torch.ops import cuda_reweight as b1

    w = workload(n, dev)
    codes, book = w["ctx"]["field_codes"]
    field = w["ctx"]["field"]
    args = lambda mask: (codes, book, *w["tf"], w["points"], mask,  # noqa: E731
                         field.resolution, field.unknown_prob)

    # cell exactness: one unmasked beam, so the beam-sum order cannot
    # matter; any cell index that moved reads another codebook value
    one = torch.zeros_like(w["mask"])
    one[int(torch.nonzero(w["mask"])[0])] = True
    got1 = b1.fused_reweight(*args(one))
    want1 = b1.fused_reweight_reference(*args(one))
    torch.cuda.synchronize()
    check(torch.equal(got1, want1),
          f"B1 {n}x{BEAMS} single beam: {int((got1 != want1).sum())} weights differ")

    got = b1.fused_reweight(*args(w["mask"]))
    want = b1.fused_reweight_reference(*args(w["mask"]))
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "B1 weights not finite")
    check(torch.allclose(got, want, rtol=1e-5, atol=0),
          f"B1 {n}x{BEAMS}: max rel err {float(((got - want).abs() / want).max()):.3g} > 1e-5")
    err = float((got - want).abs().max())

    ms = cuda_ms(lambda: b1.fused_reweight(*args(w["mask"])), iters)
    plain_ms = cuda_ms(lambda: b1.fused_reweight_reference(*args(w["mask"])), iters)
    h, wd = codes.shape
    nb = w["points"].shape[0]
    unmasked = int(w["mask"].sum())
    nbytes = h * wd + 4 * book.numel() + 16 * n + 9 * nb + 4 * n
    bms, by = bound_ms(nbytes, B1_OPS_PER_BEAM * n * unmasked)
    return dict(
        name="B1 fused_reweight", route="cuda", source="beluga_tpu_torch/csrc/reweight.cu",
        replaces="beluga_tpu/ops/pallas_reweight.py:390", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
        shape=f"{n}x{nb} ({unmasked} unmasked)",
    ), w


def check_resample(n: int, w: dict, dev, iters: int) -> dict:
    from beluga_tpu_torch.ops import cuda_resample as b2
    from beluga_tpu_torch.ops import cuda_reweight as b1
    from beluga_tpu_torch.ops.resample import sorted_multinomial_positions, systematic_positions

    codes, book = w["ctx"]["field_codes"]
    field = w["ctx"]["field"]
    weights = b1.fused_reweight_reference(codes, book, *w["tf"], w["points"], w["mask"],
                                          field.resolution, field.unknown_prob)
    weights[n // 4 : n // 4 + n // 16] = 0.0  # a block of zero-weight slots
    st = w["states"]
    values = torch.stack([st.x, st.y, st.rot.cos, st.rot.sin]).contiguous()  # D = 4
    cdf = b2.monotone_cdf(weights)
    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    pad = max(n // 32, 1)
    results = []
    for label, pos in (("sorted multinomial", sorted_multinomial_positions(gen, n)),
                       ("systematic", systematic_positions(gen, n))):
        pos = pos.clone()
        pos[-pad:] = 1.5  # padding selects nothing
        got = b2.search_take(cdf, pos, values)
        want = b2.resample_take_reference(cdf, pos, values)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"B2 {label} N=M={n}: {int((got != want).any(1).sum())} rows differ")
        idx = torch.searchsorted(cdf, pos, right=True)
        found = idx < n
        check(bool((weights[idx[found]] > 0).all()), "B2 chose a zero-weight slot")
        check(not bool(found[-pad:].any()) and bool((got[-pad:] == 0).all()),
              "B2 padded positions selected a donor")
        results.append((pos, got, want))
    pos = results[0][0]  # time the main path's positions (sorted multinomial)
    err = max(float((g - x).abs().max()) for _, g, x in results)
    ms = cuda_ms(lambda: b2.search_take(cdf, pos, values), iters)
    plain_ms = cuda_ms(lambda: b2.resample_take_reference(cdf, pos, values), iters)
    d, m = values.shape[0], pos.shape[0]
    nbytes = 4 * n + 4 * m + 4 * d * n + 4 * m * d
    bms, by = bound_ms(nbytes, m * math.ceil(math.log2(n + 1)))
    return dict(
        name="B2 resample_take", route="cuda", source="beluga_tpu_torch/csrc/resample.cu",
        replaces="beluga_tpu/ops/pallas_resample.py:369", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
        shape=f"N=M={n} D={d}",
    )


# -- phases 4 and 5: the main path --------------------------------------------


def reset_counts() -> None:
    from beluga_tpu_torch.ops import cuda_resample, cuda_reweight

    cuda_reweight.launches = 0
    cuda_resample.launches = 0


def read_counts() -> dict:
    from beluga_tpu_torch.ops import cuda_resample, cuda_reweight

    return {"B1 fused_reweight": cuda_reweight.launches,
            "B2 resample_take": cuda_resample.launches}


def run_node(dev) -> tuple[dict, dict]:
    from beluga_tpu_torch.io import synthetic
    from beluga_tpu_torch.io.config import AmclNodeConfig
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.node import AmclNode

    data = synthetic.tracking_arena(GRID, RES)
    xs, ys, yaws = synthetic.circle_trajectory(NODE_SCANS, GRID, RES)
    pts, mask = synthetic.simulate_scans(data, RES, xs, ys, yaws, BEAMS)
    cfg = AmclNodeConfig(  # nav2 defaults, initial pose at the first truth
        set_initial_pose=True, initial_pose_x=float(xs[0]), initial_pose_y=float(ys[0]),
        initial_pose_yaw=float(yaws[0]), initial_pose_covariance_x=0.25,
        initial_pose_covariance_y=0.25, initial_pose_covariance_yaw=0.068,
    )
    reset_counts()
    node = AmclNode(cfg, seed=0, device=dev)
    node.set_map(make_grid(data, RES, device=dev))
    times, worst_pos, worst_yaw, valid = [], 0.0, 0.0, 0
    for t in range(NODE_SCANS):
        t0 = time.perf_counter()
        r = node.handle_scan((xs[t], ys[t], yaws[t]), pts[t], mask[t])
        times.append(time.perf_counter() - t0)
        if not r.valid:
            continue
        valid += 1
        check(bool(np.isfinite(r.pose).all() and np.isfinite(r.covariance[:2, :2]).all()),
              f"node scan {t}: estimate not finite")
        e_pos = math.hypot(r.pose[0] - xs[t], r.pose[1] - ys[t])
        e_yaw = yaw_error(r.pose[2], yaws[t])
        worst_pos, worst_yaw = max(worst_pos, e_pos), max(worst_yaw, e_yaw)
        check(e_pos < GATE_POS_M and e_yaw < GATE_YAW_RAD,
              f"node scan {t}: error {e_pos:.3f} m / {math.degrees(e_yaw):.1f} deg")
    counts = read_counts()
    check(valid >= NODE_SCANS - 1, f"node: only {valid} valid updates of {NODE_SCANS}")
    for name, c in counts.items():
        check(c > 0, f"node: {name} was never launched")
    steady = sorted(times[2:])
    return counts, dict(
        scans=NODE_SCANS, valid=valid, worst_pos_m=worst_pos,
        worst_yaw_deg=math.degrees(worst_yaw),
        ms_per_update_median=1e3 * steady[len(steady) // 2],
        ms_per_update_mean=1e3 * sum(steady) / len(steady),
        ms_first_update=1e3 * times[0],
        active_particles=int(node._state.particles.active),
    )


def run_large_filter(dev, n: int = LARGE_N, n_min: int = LARGE_MIN,
                     scans: int = LARGE_SCANS) -> tuple[dict, dict]:
    from beluga_tpu_torch.core.random import sample_normal_se2
    from beluga_tpu_torch.filters.amcl import AmclParams, host_pose, init_state, update
    from beluga_tpu_torch.filters.builders import make_likelihood_field_filter
    from beluga_tpu_torch.io import synthetic
    from beluga_tpu_torch.maps.occupancy import make_grid

    data = synthetic.tracking_arena(GRID, RES)
    xs, ys, yaws = synthetic.circle_trajectory(scans, GRID, RES)
    pts, mask = synthetic.simulate_scans(data, RES, xs, ys, yaws, BEAMS)
    pts_d, mask_d = torch.as_tensor(pts).to(dev), torch.as_tensor(mask).to(dev)
    models, ctx = make_likelihood_field_filter(make_grid(data, RES, device=dev), device=dev)
    params = AmclParams(max_particles=n, min_particles=n_min, resampling="systematic")
    reset_counts()
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    states = sample_normal_se2(gen, n, host_pose(xs[0], ys[0], yaws[0]),
                               np.diag([0.25, 0.25, 0.068]))
    state = init_state(gen, states, params, device=dev)
    times, worst_pos, worst_yaw, active = [], 0.0, 0.0, []
    for t in range(scans):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, est = update(params, models, ctx, state, host_pose(xs[t], ys[t], yaws[t]),
                            pts_d[t], mask_d[t])
        pose = est.pose.as_xytheta().cpu().numpy()
        times.append(time.perf_counter() - t0)
        check(est.valid, f"large filter scan {t}: update gated out")
        check(bool(np.isfinite(pose).all()), f"large filter scan {t}: estimate not finite")
        e_pos = math.hypot(pose[0] - xs[t], pose[1] - ys[t])
        e_yaw = yaw_error(float(pose[2]), yaws[t])
        worst_pos, worst_yaw = max(worst_pos, e_pos), max(worst_yaw, e_yaw)
        check(e_pos < GATE_POS_M and e_yaw < GATE_YAW_RAD,
              f"large filter scan {t}: error {e_pos:.3f} m / {math.degrees(e_yaw):.1f} deg")
        active.append(int(state.particles.active))
    counts = read_counts()
    for name, c in counts.items():
        check(c > 0, f"large filter: {name} was never launched")
    steady = times[2:]
    mean_s = sum(steady) / len(steady)
    return counts, dict(
        particles=n, scans=scans, worst_pos_m=worst_pos,
        worst_yaw_deg=math.degrees(worst_yaw), ms_per_update_mean=1e3 * mean_s,
        particle_updates_per_s=n / mean_s, active_last=active[-1],
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2
    import beluga_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from beluga_tpu_torch.ops import _build

    # float32 products in full precision, stated rather than assumed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind} | {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"  {name}: {line.strip()}")

    # 3. kernels against their plain versions, on the card
    dev = torch.device("cuda")
    k_main, w_main = check_reweight(2000, dev, iters=200)
    r_main = check_resample(2000, w_main, dev, iters=200)
    k_big, w_big = check_reweight(LARGE_N, dev, iters=50)
    r_big = check_resample(LARGE_N, w_big, dev, iters=50)
    del w_main, w_big
    for k in (k_main, r_main, k_big, r_big):
        print(f"kernel {k['name']} {k['shape']}: {k['ms']:.5f} ms (plain {k['plain_ms']:.5f} ms,"
              f" bound {k['bound_ms']:.5f} ms by {k['bound_by']}), max abs err {k['max_abs_err']}")
    print("large-shape kernels: " + json.dumps({"kernels": [k_big, r_big]}))

    # 4. the node at nav2 defaults (the main path)
    node_counts, node = run_node(dev)
    print("node: " + json.dumps(node) + " launches " + json.dumps(node_counts))

    # 5. the large single filter
    large_counts, large = run_large_filter(dev)
    print("large filter: " + json.dumps(large) + " launches " + json.dumps(large_counts))

    kernels = []
    for k in (k_main, r_main):
        entry = {key: k[key] for key in ("name", "route", "source", "replaces")}
        entry["launches"] = node_counts[k["name"]]
        entry.update({key: k[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
