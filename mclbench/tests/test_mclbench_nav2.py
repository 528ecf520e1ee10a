"""The cell ``nav2_fleet.track`` on the CPU at small fleets: its check
(``reference/nav2_fleet.py``) passes the port and fails the control and
broken adaptive paths; its two readers and the counter's parser on
synthetic traces."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mclbench import counters, harness
from mclbench.metrics import fleet_kld_device_ms, kld_roofline
from mclbench.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
CELL = "nav2_fleet.track"


def test_the_cell_is_correct_loads_no_jax_and_its_control_fails():
    code = ("import sys, json; sys.path.insert(0, %r); from mclbench import harness; "
            "r = harness.run_cell(%r, 2**31 + 11, 0.2, False, device='cpu', robots=4, "
            "particles=256, control=True, log=lambda l: None); "
            "print(json.dumps([harness.forbidden_modules(), r['correct'], r['failed'], "
            "r['checks'], r['control_checks']]))" % (str(ROOT), CELL))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True).stdout
    found, correct, failed, checks, control = json.loads(out.strip().splitlines()[-1])
    assert found == [] and correct and failed == 0, checks
    assert set(checks) == set(control) == {"motion_gap", "sensor_gap", "resample_gap",
                                           "resample_ks", "recovery_gap", "estimate_gap"}
    assert any(c["value"] > c["limit"] for c in control.values()), control


def _count_off_by_one(update):
    def broken(ctx, state, odom, points, masks):
        new, est = update(ctx, state, odom, points, masks)
        p = new.particles
        return new._replace(particles=p.replace(active=p.active - 1)), est
    return broken


def _dead_slot_in_the_prefix(update):
    def broken(ctx, state, odom, points, masks):
        new, est = update(ctx, state, odom, points, masks)
        import beluga_tpu_torch as bt

        p = new.particles
        xy, z = p.state.xy.clone(), p.state.rot.z.clone()
        for t in (xy, z):  # the first slot and the last (dead) one trade places
            t[:, [0, -1]] = t[:, [-1, 0]]
        return new._replace(particles=p.replace(state=bt.SE2(xy, type(p.state.rot)(z)))), est
    return broken


def _estimate_over_every_slot(update):
    def broken(ctx, state, odom, points, masks):
        new, est = update(ctx, state, odom, points, masks)
        from beluga_tpu_torch.algorithms.estimation import estimate_se2_log

        p = new.particles
        mean, _ = estimate_se2_log(p.state, torch.zeros_like(p.log_weight),
                                   torch.full_like(p.active, p.capacity))
        return new, est._replace(pose=mean)
    return broken


@pytest.mark.parametrize("fault", [_count_off_by_one, _dead_slot_in_the_prefix,
                                   _estimate_over_every_slot])
def test_a_broken_adaptive_path_is_not_correct(fault):
    """At 2000 slots, where the counts lie near 500: a count one short, a
    dead slot in the live prefix, an estimate over the dead slots too."""
    r = harness.run_cell(CELL, 2**31 + 7, 0.2, False, device="cpu", robots=4, particles=2000,
                         fault=fault, log=lambda line: None)
    assert not r["correct"], r["checks"]


def test_a_sound_run_at_the_configuration_s_slots_is_correct():
    r = harness.run_cell(CELL, 2**31 + 7, 0.2, False, device="cpu", robots=4, particles=2000,
                         log=lambda line: None)
    assert r["correct"] and r["failed"] == 0, r["checks"]


@pytest.mark.parametrize("fault", [None, _count_off_by_one])
def test_robots_that_stand_keep_their_slots_and_counts(monkeypatch, fault):
    """The configuration under ``half_idle``'s traffic (at seed 5 an armed
    tick finds every robot standing): the check holds each standing
    filter's slots and count as they were, and a count that moves fails."""
    from mclbench import generator

    bench, cell, config, _ = harness.cell_files(CELL)
    idle = generator.load_mix("half_idle")
    monkeypatch.setattr(harness, "cell_files", lambda name: (bench, cell, config, idle))
    r = harness.run_cell(CELL, 5, 0.3, False, device="cpu", robots=4, particles=256,
                         fault=fault, log=lambda line: None)
    assert r["correct"] == (fault is None), r["checks"]


def test_the_take_while_is_beluga_s():
    from mclbench.reference import nav2_fleet as ref

    # min 2: the third candidate, in a third bucket, meets target(3) = 37
    assert ref.take_while([1, 2, 3, 3], 2, 10, 0.05, 0.99) == 4
    assert ref.take_while([7] * 50, 5, 100, 0.05, 0.99) == 50  # k ≤ 2: no bound
    three = [0, 1, 2] + [2] * 47  # three buckets: target 37
    assert ref.take_while(three, 5, 100, 0.05, 0.99) == 37  # the 38th: 38 > 37
    assert ref.take_while(three, 40, 100, 0.05, 0.99) == 40  # up to min, whatever the target
    assert ref.take_while(three, 5, 20, 0.05, 0.99) == 20  # at most max
    assert ref.take_while(list(range(50)), 5, 100, 0.05, 0.99) == 50  # target(k) > k
    assert ref.kld_target(3, 0.05, 0.99) == 37 and ref.kld_target(10, 0.05, 0.99) == 131


# -- the readers --------------------------------------------------------------------------


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1, "args": args}


def _launch(ts, corr, start, dur):
    return [_ev("cuda_runtime", "cudaLaunchKernel", ts, 1, correlation=corr),
            _ev("kernel", f"k{corr}", start, dur, correlation=corr)]


def two_kld_ticks(counts=True):
    """Two ticks whose KLD stage launches 40 and 60 µs of kernels (one
    inside the hash's model-table span); each tick marks its live total."""
    events = []
    for t0, live, kernels in ((0, 2_048_000, ((20, 1, 22, 30), (30, 2, 33, 10))),
                              (200, 3_000_000, ((220, 3, 222, 60),))):
        events += [_ev("user_annotation", "tick", t0, 200),
                   _ev("user_annotation", "amcl.update", t0 + 5, 150),
                   _ev("user_annotation", "amcl.resample", t0 + 10, 50),
                   _ev("user_annotation", "amcl.kld", t0 + 15, 40),
                   _ev("user_annotation", "models.hash_state", t0 + 16, 10)]
        if counts:
            events.append(_ev("user_annotation", f"count.kld.live={live}", t0 + 190, 0))
        for k in kernels:
            events += _launch(*k)
    events += _launch(100, 9, 101, 50)  # outside the stage
    return Trace(events)


def _ctx(tr, robots=4096):
    return harness.TraceContext(tr, {}, robots, 2000)


def test_the_counter_s_values_in_their_order():
    tr = two_kld_ticks()
    assert counters.values(tr, "kld.live") == [2_048_000, 3_000_000]
    assert counters.values(tr, "kld") == [] and counters.values(Trace([]), "kld.live") == []


def test_kld_device_ms_and_roofline():
    tr = two_kld_ticks()
    assert fleet_kld_device_ms.read(_ctx(tr)) == pytest.approx((40 + 60) * 1e-3 / 2)
    need = ((16 * 2_048_000 + 4 * 4096) + (16 * 3_000_000 + 4 * 4096)) / 2 / 3.35e12
    assert kld_roofline.read(_ctx(tr)) == pytest.approx(100.0 * need / 50e-6)


def test_kld_readers_without_the_stage_or_the_counter():
    """A program without the counter (the parent's) leaves the roofline
    out; an update without the stage (a fixed count) reads 0 ms; a trace
    without the program's ranges, nothing."""
    assert kld_roofline.read(_ctx(two_kld_ticks(counts=False))) is None
    assert fleet_kld_device_ms.read(_ctx(two_kld_ticks(counts=False))) > 0
    fixed = Trace([_ev("user_annotation", "tick", 0, 100),
                   _ev("user_annotation", "amcl.update", 10, 80), *_launch(20, 1, 25, 10)])
    assert fleet_kld_device_ms.read(_ctx(fixed)) == 0.0
    assert kld_roofline.read(_ctx(fixed)) is None
    bare = Trace([_ev("user_annotation", "tick", 0, 100), *_launch(20, 1, 25, 10)])
    assert fleet_kld_device_ms.read(_ctx(bare)) is None and kld_roofline.read(_ctx(bare)) is None


def test_the_program_s_counter_in_a_profiler_trace(tmp_path):
    """``count`` marks nothing without a profiler, and under one a range
    that the trace loads and the parser reads."""
    from torch.profiler import ProfilerActivity, profile

    from beluga_tpu_torch.utils.profiling import count

    count("kld.live", 5)  # no profiler: nothing to mark, nothing raised
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("tick"):
            count("kld.live", 1234567)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    tr = Trace.load(tmp_path / "trace.json")
    assert tr.ticks == 1 and counters.values(tr, "kld.live") == [1234567]


@pytest.mark.cuda
def test_on_the_card_the_port_passes_and_the_control_fails(card):
    """At the configuration's 2000 slots on 64 robots: three seeds, each
    correct, the control failing at least one number on each."""
    for seed in (13, 2**31 + 17, 4099):
        r = harness.run_cell(CELL, seed, 1.0, False, device=card, robots=64,
                             log=lambda line: None, control=True)
        assert r["correct"] and r["failed"] == 0, r["checks"]
        assert any(c["value"] > c["limit"] for c in r["control_checks"].values())
