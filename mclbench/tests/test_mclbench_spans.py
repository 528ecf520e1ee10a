"""The readers of the metrics that read the program's own ranges: the
update's stages (``amcl.*``) and its host-device syncs (``sync.*``), on
synthetic traces: counts, host milliseconds and device milliseconds a
tick, the kernels of nested ranges included; 0 where the update ran
without the stage or the sync, nothing where the program marks no
update."""

import importlib

import pytest

from mclbench import harness
from mclbench.trace import Trace

METRICS = ("fleet.syncs_per_tick", "fleet.sync_wait_ms", "fleet.recovery_host_ms",
           "fleet.resample_device_ms", "fleet.sort_device_ms", "fleet.select_device_ms",
           "fleet.estimate_device_ms")


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1, "args": args}


def _launch(ts, corr, start, dur):
    return [_ev("cuda_runtime", "cudaLaunchKernel", ts, 1, correlation=corr),
            _ev("kernel", f"k{corr}", start, dur, correlation=corr)]


def two_ticks():
    """Tick 1 resamples (its recovery syncs once), sorts, keeps some
    filters and estimates, after the motion's sync; tick 2 only estimates."""
    events = [
        _ev("user_annotation", "tick", 0, 200),
        _ev("user_annotation", "fleet.update", 5, 145),
        _ev("user_annotation", "amcl.update", 10, 130),
        _ev("user_annotation", "sync.motion_coefficients", 12, 6),
        _ev("user_annotation", "amcl.resample", 20, 60),
        _ev("user_annotation", "amcl.recovery", 30, 30),
        _ev("user_annotation", "models.random_state", 32, 26),
        _ev("user_annotation", "sync.recovery_sqrt_cov", 40, 15),
        _ev("user_annotation", "amcl.sort", 85, 10),
        _ev("user_annotation", "amcl.select", 96, 4),
        _ev("user_annotation", "amcl.estimate", 100, 30),
        _ev("gpu_memcpy", "Memcpy HtoD", 15, 2),
        _ev("user_annotation", "tick", 200, 200),
        _ev("user_annotation", "amcl.update", 210, 90),
        _ev("user_annotation", "amcl.estimate", 220, 30),
    ]
    for ts, corr, start, dur in ((25, 1, 26, 10),  # the resample's own
                                 (35, 2, 40, 20),  # in the recovery
                                 (45, 3, 60, 5),  # in the recovery's sync, in a model-table span
                                 (90, 4, 92, 7),  # the sort
                                 (98, 5, 101, 3),  # the select
                                 (110, 6, 112, 30),  # the estimate
                                 (230, 7, 232, 30)):  # tick 2's estimate
        events += _launch(ts, corr, start, dur)
    return Trace(events)


def read(tr, metric):
    reader = importlib.import_module(f"mclbench.metrics.{metric.replace('.', '_')}")
    return reader.read(harness.TraceContext(tr, {}, 4, 64))


def test_counts_and_host_ms_of_the_program_ranges():
    tr = two_ticks()
    assert tr.ticks == 2
    assert read(tr, "fleet.syncs_per_tick") == 1.0  # two syncs over two ticks
    assert read(tr, "fleet.sync_wait_ms") == pytest.approx((6 + 15) * 1e-3 / 2)
    assert read(tr, "fleet.recovery_host_ms") == pytest.approx(30 * 1e-3 / 2)


@pytest.mark.parametrize("metric,us", [
    ("fleet.resample_device_ms", 10 + 20 + 5),  # nested launches taken in
    ("fleet.sort_device_ms", 7),
    ("fleet.select_device_ms", 3),
    ("fleet.estimate_device_ms", 30 + 30),
])
def test_device_ms_of_the_kernels_launched_from_a_stage(metric, us):
    assert read(two_ticks(), metric) == pytest.approx(us * 1e-3 / 2)


def test_an_update_without_the_stage_or_a_sync_reads_zero():
    tr = Trace([_ev("user_annotation", "tick", 0, 100),
                _ev("user_annotation", "amcl.update", 10, 80),
                _ev("user_annotation", "amcl.estimate", 20, 30),
                *_launch(25, 1, 30, 12)])
    for metric in METRICS:
        want = 0.012 if metric == "fleet.estimate_device_ms" else 0.0
        assert read(tr, metric) == pytest.approx(want), metric
    assert read(tr, "fleet.select_device_ms") == 0.0
    assert read(tr, "fleet.syncs_per_tick") == 0.0


def test_a_program_without_its_ranges_reads_nothing():
    """The benchmark's own spans alone, as a program without its own ranges
    leaves them: every new metric is left out of the line."""
    tr = Trace([_ev("user_annotation", "tick", 0, 100),
                _ev("user_annotation", "fleet.update", 5, 80),
                _ev("user_annotation", "models.log_weight", 10, 20),
                *_launch(12, 1, 20, 30)])
    assert all(read(tr, metric) is None for metric in METRICS)
    assert all(read(Trace([]), metric) is None for metric in METRICS)  # no tick


def test_every_new_metric_has_its_entry():
    import json

    bench = json.loads((harness.BENCHMARK).read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for metric in METRICS:
        assert "workloads" not in entries[metric]  # every cell
        assert entries[metric]["source"] in ("program_span", "device_trace")
