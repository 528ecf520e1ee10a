import math

import pytest

from mclbench import harness, roofline
from mclbench.sensors import likelihood_field, ndt
from mclbench.trace import Trace


def test_end_to_end_over_all_ticks_with_a_stall():
    ticks = [0.010] * 99 + [0.500]  # one stalled tick
    m = harness.end_to_end(ticks, 100 * 1000, sum(ticks), 12.5)
    assert m["particle_updates_per_s"] == pytest.approx(100_000 / 1.49)
    assert m["tick_ms_p95"] == pytest.approx(10.0)
    ticks = [0.010] * 90 + [0.500] * 10  # ten beyond the 95th percentile
    assert harness.end_to_end(ticks, 1, 1.0, 0.0)["tick_ms_p95"] == pytest.approx(500.0)
    # linear between order statistics, as numpy's percentile
    assert harness.end_to_end([0.001 * i for i in range(1, 21)], 1, 1.0, 0.0)[
        "tick_ms_p95"] == pytest.approx(19.05)


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1, "args": args}


def synthetic_trace():
    return Trace([
        _ev("user_annotation", "tick", 0, 100),
        _ev("user_annotation", "models.log_weight", 10, 20),
        _ev("user_annotation", "tick.readback", 80, 20),
        _ev("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 40, 1, correlation=2),
        _ev("cuda_driver", "cuLaunchKernel", 15, 1, correlation=3),
        _ev("kernel", "a", 20, 30, correlation=1),  # [20, 50)
        _ev("kernel", "b", 40, 20, correlation=2),  # overlaps a: [40, 60)
        _ev("kernel", "c", 70, 5, correlation=3),  # [70, 75)
        _ev("gpu_memcpy", "Memcpy HtoD", 95, 10),  # runs past the window's end
        _ev("kernel", "late", 200, 10, correlation=9),  # outside the window
    ])


def test_idle_share_is_the_union_of_busy_intervals():
    tr = synthetic_trace()
    assert tr.ticks == 1 and tr.window_us() == 100
    assert tr.busy_us() == 40 + 5 + 5  # [20, 60) + [70, 75) + [95, 100)
    from mclbench.metrics import device_busy_ms_per_tick, device_idle_share, fleet_launches_per_tick

    ctx = harness.TraceContext(tr, {}, 1, 1)
    assert device_idle_share.read(ctx) == pytest.approx(50.0)
    assert device_busy_ms_per_tick.read(ctx) == pytest.approx(0.05)  # 50 us in one tick
    assert fleet_launches_per_tick.read(ctx) == 3  # "late" started after the window


def test_kernels_by_the_span_they_were_launched_from():
    tr = synthetic_trace()
    assert tr.kernel_us_under("models.log_weight") == 30 + 5  # a and c, by correlation
    gaps = dict(tr.breakdown()["idle_gaps"])
    assert gaps["models.log_weight"] == pytest.approx(20e-6)  # [0, 20)
    assert gaps["tick.readback"] == pytest.approx(20e-6)  # [75, 95)
    name, seconds = tr.breakdown()["device_ops"][0]
    assert name == "a" and seconds == pytest.approx(30e-6)


def test_roofline_counts_match_the_kernel_table():
    # PERF.md §6 at 64 x 4096 x 60: B4's bound 0.001663393432835821 ms by its bytes
    ops, nbytes = likelihood_field.counts(4096, 64, 64 * 24, 60, 384 * 384)  # 24 hits a scan
    assert nbytes / roofline.PEAK_BYTES_PER_S * 1e3 == pytest.approx(0.001663393432835821)
    assert roofline.least_seconds(ops, nbytes) == nbytes / roofline.PEAK_BYTES_PER_S
    # the fused NDT kernel's 0.010132356477611942 ms by its operations (11 live cells,
    # 287 map rows, 38.7% of the probes hits)
    ops, nbytes = ndt.counts(4096, 64, 64 * 11, 0.387 * 9 * 64 * 11, 60, 287)
    assert ops / roofline.PEAK_F32_PER_S * 1e3 == pytest.approx(0.010132356477611942, rel=3e-3)
    assert nbytes == 28 * 4096 * 64 + 25 * 60 * 64 + 28 * 287
    assert math.isclose(roofline.least_seconds(ops, nbytes), ops / roofline.PEAK_F32_PER_S)


def test_live_cells_count_five_points_a_cell():
    import torch

    pts = torch.tensor([[[0.1, 0.1]] * 5 + [[1.0, 1.0]] * 4 + [[-0.1, 0.1]]])
    mask = torch.ones(pts.shape[:2], dtype=torch.bool)
    assert ndt.live_cells(pts, mask, 0.4).tolist() == [1]  # -0.1 truncates to cell 0


def test_sensor_work_of_a_tick_sums_its_robots():
    """Each sensor's count of a tick's work, from the lattice's scans, sums
    its robots' scans; the NDT probes that hit are counted at each pose."""
    import numpy as np

    from mclbench import world

    _, _, config, _ = harness.cell_files("ndt_fleet.track")
    data = world.tracking_arena(384, 0.05)
    poses = world.lattice_poses(6, 384, 0.05, 1.2)
    pts, mask = world.cast_scans(data, 0.05, poses, 360, 3.5, "cpu")
    work = ndt.work(config, data, pts, mask, poses, 4096)
    live = ndt.live_cells(pts, mask, 0.4)
    one = [work(np.array([k])) for k in range(6)]
    both = work(np.array([0, 3]))
    assert both[0] == pytest.approx(one[0][0] + one[3][0])
    assert all(o > 4096 * (ndt.CELL_OPS + ndt.PROBE_OPS * 9) * int(c) for (o, _), c in
               zip(one, live) if c)  # some probes hit
    _, _, config, _ = harness.cell_files("lf_fleet.track")
    pts, mask = world.cast_scans(data, 0.05, poses, 60, 3.5, "cpu")
    work = likelihood_field.work(config, data, pts, mask, poses, 4096)
    assert work(np.array([1, 2])) == likelihood_field.counts(
        4096, 2, int(mask[1:3].sum()), 60, 384 * 384)
