#!/usr/bin/env python3
"""Build and drive the PyTorch + CUDA port (``beluga_tpu_torch``) on one
NVIDIA GPU, and fail unless it is right.

    python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:

1. device: the card's name and power limit;
2. build: every ``beluga_tpu_torch/csrc/*.cu`` with nvcc, one process per
   source, started together;
3. kernels: each kernel's wrapper on card tensors at the shapes the main
   paths give it (the node's 2000 particles x 60 beams, the fleet's 64
   filters x 4096 particles x 60 beams, the large and windowed filters'
   262144, the mega filter's 2097152), held against its plain PyTorch
   version on the same inputs and timed beside it: B1 (exact reweight), B4
   (codebook16 reweight), B2 (resample take), B3 (pool take), B6 (windowed
   LUT lookup, beside ``grid_sample`` as the library yardstick) and B5
   (fused propagate + lookup).  ``ms`` is the time per call of calls
   issued back to back, the wrapper's host cost included; ``device_ms`` is
   the device's own time per call under ``torch.profiler``;
4. node: ``AmclNode`` at nav2 defaults tracks the synthetic arena's circle
   for 50 scans; every valid estimate must lie within 0.9 m / 30 degrees
   of the truth, and B1 and B2 must have been launched;
5. large filter: one 262144-particle filter (systematic resampling, KLD
   down to 65536, pooled recovery) through ``filters.amcl.update`` for 12
   scans, same gate; B1, B2 and B3 launched;
6. fleet: 64 filters x 4096 particles in codebook16 mode with theta-sorted
   slots and pooled recovery through ``parallel.fleet.make_fleet_update``
   for 40 scans, same gate on every filter; B4, B2 and B3 launched once per
   update, B1 never;
7. mega: the JAX benchmark's headline filter, 1 x 2097152 particles x 60
   beams through the fused windowed kernel B5 (``bench.py:247-386``), 64
   forced updates with the theta sort on every 8th; every scan within
   0.9 m / 30 degrees and the last 32 within 0.35 m (the benchmark's own
   gate on its last block, ``bench.py:364-377``); B5 launched once per
   update, B1, B4 and B6 never;
8. windowed: the coverage-gated windowed filter, 262144 particles
   (``bench.py:880-900``), 40 forced updates, same 0.9 m / 30 degree gate;
   B6 launched at least once, B1 on every update (the exact tail, or the
   fallback); prints how many updates took each branch;
9. beam node: ``AmclNode`` with ``laser_model_type="beam"`` at nav2
   defaults (100 m range) in each ``beam_fast_path`` for 30 scans, same
   gate; R1 on every update in ``exact``, R1 once (the range-LUT build) in
   ``lut`` and ``windowed``, B8 on every update in ``sphere_trace``, B7 on
   every update in ``windowed``, B2 in all four;
10. long range: the JAX package's long-range beam row (1024² map at 0.1 m,
   2048 particles x 60 beams, 60 m, sphere trace), 40 forced updates along
   the arc of ``tests/test_system_long_range.py``; every scan after the 2
   warm-up scans within the gate; B8 once per update;
11. beam fleet: 64 filters x 4096 particles x 60 beams through the
   windowed range LUT (``bench.py:678-720``) for 40 scans, every filter
   within the gate; B7 once per update, B1 and B4 never, R1 during the
   build (its time printed).

Phase 3 also holds kernels B8 (the node's 2000 x 60 at 100 m and the
long-range 2048 x 60 at 60 m), B7 (64 x 4096 x 60, K = 128, θ-sorted slots
with strays) and R1 (the node's 2000 x 60 rays at 100 m and the LUT
build's 128 x 384 x 384 rays at 4 m) against their plain versions.

Phases 4 to 11 run the configurations of ``beluga_tpu_torch/tools/workloads.py``.

Each path's launch counts are set to 0 just before it runs and read just
after.  The line before the last two is the ``kernels`` JSON; the line
before the last is ``nvidia-smi``'s name and power limit; the last line is
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
# endpoint transform, 2 divisions, 2 for the cube, 1 for the sum; kernel B4
# reads the cube from its table
B1_OPS_PER_BEAM = 13
B4_OPS_PER_BEAM = 11
# float32 operations per particle of kernel B6: 6 tents of 3, 14 products
# and 7 sums of the trilinear read, the base; kernel B5 adds the motion
# sample, the window affine and the heading bin (~40 with sincos counted
# as 8 each) and the log
B6_OPS_PER_PARTICLE = 40
B5_OPS_PER_PARTICLE = 120
EDGE = 1e-4  # window coordinates this close to an edge may flip validity

GATE_POS_M = 0.9  # tests/test_system.py:44-45
GATE_YAW_RAD = math.radians(30.0)
NODE_SCANS = 50
LARGE_N, LARGE_MIN, LARGE_SCANS = 262144, 65536, 12
MEGA_N = 2097152  # bench.py:266
FLEET_B, FLEET_N, FLEET_SCANS = 64, 4096, 40  # bench.py:46-49
MEGA_SCANS, MEGA_LAST, MEGA_LAST_GATE_M = 64, 32, 0.35  # bench.py:364-377
WINDOWED_SCANS = 40
BEAM_NODE_SCANS, LONG_RANGE_SCANS, LONG_RANGE_WARMUP, BEAM_FLEET_SCANS = 30, 40, 2, 40
# float32 operations per (particle, unmasked beam) of the beam mixture, with
# exp counted as 10: two A&S erfs of ~28, eta_hit 6, the Gaussian 17, the
# short term 26, the rest 6; kernel B7 adds the bin and the blend (12),
# kernel B8 the ray direction (6) and 8 per trace step; kernel R1 takes ~10
# integer operations per visited cell
MIXTURE_OPS = 110
B7_OPS_PER_BEAM = MIXTURE_OPS + 12
B8_OPS_PER_BEAM, B8_OPS_PER_STEP = MIXTURE_OPS + 6, 8
R1_OPS_PER_CELL = 10


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def cuda_ms(fn, iters: int) -> float:
    """Mean time per call of ``fn`` over ``iters`` calls back to back
    (CUDA events), after a warm-up.  It includes the host's cost of issuing
    each call wherever that exceeds the device's time for it."""
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


def device_ms(fn, iters: int) -> float | None:
    """Mean device time per call of ``fn``: the summed durations of the
    kernels and copies it ran under ``torch.profiler``, which leaves the
    host's cost out; None when the profiler saw no device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    return 1e-3 * busy_us / iters if busy_us > 0 else None


def timings(kernel, plain, iters: int, library=None, plain_iters: int | None = None) -> dict:
    """``ms``, ``plain_ms`` and ``library_ms`` (``cuda_ms``) and their
    ``device_ms`` counterparts for a kernel's wrapper, its plain version
    and the library call (None where there is none); ``plain_iters``
    bounds the calls of a slow plain version."""
    out = {}
    for key, fn in (("ms", kernel), ("plain_ms", plain), ("library_ms", library)):
        n = plain_iters if key == "plain_ms" and plain_iters else iters
        out[key] = None if fn is None else cuda_ms(fn, n)
        out[key.replace("ms", "device_ms")] = None if fn is None else device_ms(fn, min(n, 20))
    return out


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def yaw_error(a: float, b: float) -> float:
    return abs(math.atan2(math.sin(a - b), math.cos(a - b)))


# -- phase 3: kernels against their plain versions ---------------------------


def workload(n: int, dev, batch: int | None = None):
    """Field code table, particles and one scan of the tracking workload:
    per filter, 90% of the particles in a cloud about the first pose, 10%
    spread over a box larger than the map (some endpoints fall off the
    map).  One filter ``[n]``, or ``batch`` filters ``[batch, n]`` that
    score the same scan, as the fleet does."""
    from beluga_tpu_torch.filters.builders import make_likelihood_field_filter
    from beluga_tpu_torch.io.config import AmclNodeConfig
    from beluga_tpu_torch.lie import SE2
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.tools.workloads import GRID, RES, arena_scans

    data, xs, ys, yaws, pts, mask = arena_scans(1)
    _, ctx = make_likelihood_field_filter(
        make_grid(data, RES, device=dev),
        AmclNodeConfig().likelihood_field_params(), device=dev,
    )
    lead = () if batch is None else (batch,)
    rng = np.random.default_rng(n * (batch or 1))
    near = int(n * 0.9)

    def mix(center, sd, lo, hi):
        return np.concatenate([rng.normal(center, sd, (*lead, near)),
                               rng.uniform(lo, hi, (*lead, n - near))], axis=-1)

    px = mix(xs[0], 0.5, -2, GRID * RES + 2)
    py = mix(ys[0], 0.5, -2, GRID * RES + 2)
    pth = mix(yaws[0], 0.26, -np.pi, np.pi)
    states = SE2.from_xytheta(px.astype(np.float32), py.astype(np.float32),
                              pth.astype(np.float32), device=dev)
    tf = ctx["field"].world_to_field @ states
    points = torch.as_tensor(pts[0]).to(dev)
    beams = torch.as_tensor(mask[0]).to(dev)
    return dict(
        ctx=ctx, lead=lead,
        tf=[t.contiguous() for t in (tf.x, tf.y, tf.rot.cos, tf.rot.sin)],
        states=states,
        points=points.expand(*lead, *points.shape).contiguous(),
        mask=beams.expand(*lead, *beams.shape).contiguous(),
    )


def shape_label(w: dict, n: int) -> str:
    b = w["lead"][0] if w["lead"] else 1
    nb = w["points"].shape[-2]
    return f"{b}x{n}x{nb} ({int(w['mask'][(0,) * len(w['lead'])].sum())} unmasked)"


def single_beam(mask: torch.Tensor) -> torch.Tensor:
    """The mask with only its first unmasked beam left on (every filter
    scores the same scan)."""
    first = int(torch.nonzero(mask.reshape(-1, mask.shape[-1])[0])[0])
    one = torch.zeros_like(mask)
    one[..., first] = True
    return one


def check_reweight(n: int, dev, iters: int, batch: int | None = None) -> tuple[dict, dict]:
    from beluga_tpu_torch.ops import cuda_reweight as b1

    w = workload(n, dev, batch)
    codes, book = w["ctx"]["field_codes"]
    field = w["ctx"]["field"]
    args = lambda mask: (codes, book, *w["tf"], w["points"], mask,  # noqa: E731
                         field.resolution, field.unknown_prob)

    # cell exactness: one unmasked beam, so the beam-sum order cannot
    # matter; any cell index that moved reads another codebook value
    one = single_beam(w["mask"])
    got1 = b1.fused_reweight(*args(one))
    want1 = b1.fused_reweight_reference(*args(one))
    torch.cuda.synchronize()
    label = shape_label(w, n)
    check(torch.equal(got1, want1),
          f"B1 {label} single beam: {int((got1 != want1).sum())} weights differ")

    got = b1.fused_reweight(*args(w["mask"]))
    want = b1.fused_reweight_reference(*args(w["mask"]))
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "B1 weights not finite")
    check(torch.allclose(got, want, rtol=1e-5, atol=0),
          f"B1 {label}: max rel err {float(((got - want).abs() / want).max()):.3g} > 1e-5")
    err = float((got - want).abs().max())
    w["b1_weights"] = got

    times = timings(lambda: b1.fused_reweight(*args(w["mask"])),
                    lambda: b1.fused_reweight_reference(*args(w["mask"])), iters)
    h, wd = codes.shape
    total, filters = w["tf"][0].numel(), batch or 1
    nb = w["points"].shape[-2]
    unmasked = int(w["mask"].sum())  # over every filter
    nbytes = h * wd + 4 * book.numel() + 16 * total + 9 * nb * filters + 4 * total
    bms, by = bound_ms(nbytes, B1_OPS_PER_BEAM * n * unmasked)
    return dict(
        name="B1 fused_reweight", route="cuda", source="beluga_tpu_torch/csrc/reweight.cu",
        replaces="beluga_tpu/ops/pallas_reweight.py:390", max_abs_err=err,
        bound_ms=bms, bound_by=by, shape=label, **times,
    ), w


def check_codebook16(n: int, w: dict, iters: int) -> dict:
    """Kernel B4 on ``check_reweight``'s inputs: single-beam weights equal,
    60-beam weights within rtol 1e-5 of its plain version and within 5e-3
    of B1's exact weights."""
    from beluga_tpu_torch.ops import cuda_reweight as b1

    codes, book = w["ctx"]["field_codes"]
    field = w["ctx"]["field"]
    v3 = b1.build_values3(codes, book)

    def kernel(mask):
        return b1.fused_reweight(codes, book, *w["tf"], w["points"], mask, field.resolution,
                                 field.unknown_prob, values3=v3)

    def plain(mask):
        return b1.fused_reweight_values3_reference(v3, *w["tf"], w["points"], mask,
                                                   field.resolution, field.unknown_prob)

    label = shape_label(w, n)
    one = single_beam(w["mask"])
    got1, want1 = kernel(one), plain(one)
    torch.cuda.synchronize()
    check(torch.equal(got1, want1),
          f"B4 {label} single beam: {int((got1 != want1).sum())} weights differ")
    got, want = kernel(w["mask"]), plain(w["mask"])
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "B4 weights not finite")
    check(torch.allclose(got, want, rtol=1e-5, atol=0),
          f"B4 {label}: max rel err {float(((got - want).abs() / want).max()):.3g} > 1e-5")
    rel_b1 = float(((got - w["b1_weights"]).abs() / w["b1_weights"]).max())
    check(rel_b1 < 5e-3, f"B4 {label}: {rel_b1:.3g} relative to B1's exact weights")
    times = timings(lambda: kernel(w["mask"]), lambda: plain(w["mask"]), iters)
    h, wd = codes.shape
    total, filters = w["tf"][0].numel(), (w["lead"][0] if w["lead"] else 1)
    nb = w["points"].shape[-2]
    nbytes = 2 * h * wd + 16 * total + 9 * nb * filters + 4 * total
    bms, by = bound_ms(nbytes, B4_OPS_PER_BEAM * n * int(w["mask"].sum()))
    return dict(
        name="B4 fused_reweight values3", route="cuda",
        source="beluga_tpu_torch/csrc/reweight.cu",
        replaces="beluga_tpu/ops/pallas_reweight.py:390 (values3=, build_values3:364)",
        max_abs_err=float((got - want).abs().max()), rel_to_b1=rel_b1,
        bound_ms=bms, bound_by=by, shape=label, **times,
    )


def check_resample(n: int, w: dict, dev, iters: int) -> dict:
    from beluga_tpu_torch.ops import cuda_resample as b2
    from beluga_tpu_torch.ops.resample import sorted_multinomial_positions, systematic_positions

    lead = w["lead"]
    weights = w["b1_weights"].clone()
    block = (0,) * len(lead)  # one filter holds a block of zero-weight slots
    weights[block][n // 4 : n // 4 + n // 16] = 0.0
    st = w["states"]
    values = torch.stack([st.x, st.y, st.rot.cos, st.rot.sin], dim=-2).contiguous()  # D = 4
    cdf = b2.monotone_cdf(weights)
    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    pad = max(n // 32, 1)
    results = []
    for label, pos in (("sorted multinomial", sorted_multinomial_positions(gen, n, lead)),
                       ("systematic", systematic_positions(gen, n, lead))):
        pos = pos.clone()
        pos[..., -pad:] = 1.5  # padding selects nothing
        got = b2.search_take(cdf, pos, values)
        want = b2.resample_take_reference(cdf, pos, values)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"B2 {label} {lead} N=M={n}: {int((got != want).any(-1).sum())} rows differ")
        idx = torch.searchsorted(cdf, pos, right=True)
        found = idx < n
        chosen = torch.take_along_dim(weights, torch.clamp_max(idx, n - 1), dim=-1)
        check(bool((chosen[found] > 0).all()), "B2 chose a zero-weight slot")
        check(not bool(found[..., -pad:].any()) and bool((got[..., -pad:, :] == 0).all()),
              "B2 padded positions selected a donor")
        results.append((pos, got, want))
    pos = results[0][0]  # time the main path's positions (sorted multinomial)
    err = max(float((g - x).abs().max()) for _, g, x in results)
    times = timings(lambda: b2.search_take(cdf, pos, values),
                    lambda: b2.resample_take_reference(cdf, pos, values), iters)
    filters = lead[0] if lead else 1
    d, m = values.shape[-2], pos.shape[-1]
    nbytes = filters * (4 * n + 4 * m + 4 * d * n + 4 * m * d)
    bms, by = bound_ms(nbytes, filters * m * math.ceil(math.log2(n + 1)))
    return dict(
        name="B2 resample_take", route="cuda", source="beluga_tpu_torch/csrc/resample.cu",
        replaces="beluga_tpu/ops/pallas_resample.py:369", max_abs_err=err,
        bound_ms=bms, bound_by=by, **times,
        shape=f"{filters}x N=M={n} D={d}",
    )


def check_pool_take(batch: int | None, p: int, n: int, dev, iters: int) -> dict:
    """Kernel B3 on a pool of ``p`` (x, y) rows: bit-equal to its plain
    version with some indices out of range, timed on in-range indices (the
    sampler's)."""
    from beluga_tpu_torch.ops import cuda_pool_take as b3

    lead = () if batch is None else (batch,)
    gen = torch.Generator(device=dev)
    gen.manual_seed(p + n)
    pool = torch.randn((*lead, p, 2), generator=gen, device=dev)
    wild = torch.randint(-8, p + 8, (*lead, n), generator=gen, device=dev, dtype=torch.int32)
    got, want = b3.pool_take(pool, wild), b3.pool_take_reference(pool, wild)
    torch.cuda.synchronize()
    label = f"[{', '.join(map(str, (*lead, p, 2)))}] x {n}"
    check(torch.equal(got, want), f"B3 {label}: {int((got != want).any(-1).sum())} rows differ")
    outside = (wild < 0) | (wild >= p)
    check(bool(outside.any()) and bool((got[outside] == 0).all()),
          "B3 out-of-range indices did not give zero rows")
    idx = torch.randint(0, p, (*lead, n), generator=gen, device=dev, dtype=torch.int32)
    gather_idx = idx.long()[..., None].expand(*idx.shape, 2).contiguous()
    times = timings(lambda: b3.pool_take(pool, idx), lambda: b3.pool_take_reference(pool, idx),
                    iters, library=lambda: torch.gather(pool, -2, gather_idx))
    filters, c = (batch or 1), 2
    bms, by = bound_ms(filters * (n * (4 + 4 * c) + p * c * 4), 0)
    return dict(
        name="B3 pool_take", route="cuda", source="beluga_tpu_torch/csrc/pool_take.cu",
        replaces="beluga_tpu/ops/pallas_lookup.py:153", max_abs_err=float((got - want).abs().max()),
        bound_ms=bms, bound_by=by, shape=label, **times,
    )


def resample_inputs(n: int, dev) -> dict:
    """Inputs of ``check_resample`` without a reweight: positive random
    weights and a random cloud of ``n`` particles."""
    from beluga_tpu_torch.lie import SE2

    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    xyt = torch.randn((3, n), generator=gen, device=dev)
    weights = torch.rand(n, generator=gen, device=dev) + 0.5
    return dict(lead=(), b1_weights=weights, states=SE2.from_xytheta(xyt[0], xyt[1], xyt[2]))


def window_inputs(w, cfg: dict, stray_every: int = 20):
    """The workload's θ-sorted cloud with every ``stray_every``-th slot moved
    5 m off (it scores miss), and the window LUT of its first scan about the
    cloud's mean, built as the filter builds it."""
    from beluga_tpu_torch.lie import SE2
    from beluga_tpu_torch.models.sensor.likelihood_field_winlut import build_windowed_scan_lut

    st = w.state.particles.state
    xy = st.xy.clone()
    xy[::stray_every] += 5.0
    states = SE2(xy, st.rot)
    ct = torch.atan2(torch.mean(st.rot.sin), torch.mean(st.rot.cos))
    geo = {k: v for k, v in cfg.items() if k in ("k_bins", "win", "dth", "max_point_radius")}
    lut = build_windowed_scan_lut(w.ctx["field"], w.points[0], w.mask[0], torch.mean(st.x),
                                  torch.mean(st.y), ct, padded_cubed=w.ctx["field_pad3"],
                                  dft=w.ctx["winlut_dft"], **geo)
    return states, lut


def check_winlut(dev, iters: int) -> dict:
    """Kernel B6 at the windowed filter's geometry (262144 particles, 64
    bins, a 128x128 window, tile 512, tblk 16; a θ-sorted cloud whose tiles
    span several slabs): within rtol 1e-6 of its plain version with an
    equal miss set, timed beside its plain version and ``grid_sample``
    (trilinear, ``align_corners=True``, the same coordinates, no slab rule),
    the library yardstick the port never calls."""
    import torch.nn.functional as F

    from beluga_tpu_torch.models.sensor.likelihood_field_winlut import windowed_coords
    from beluga_tpu_torch.ops import cuda_winlut as b6
    from beluga_tpu_torch.tools import workloads

    cfg = workloads.WINDOWED_FILTER
    states, lut = window_inputs(workloads.windowed(1, dev), cfg)
    tile, tblk = cfg["tile"], cfg["tblk"]
    xi, yi, t = (v.contiguous() for v in windowed_coords(lut, states))
    k, wx, wy = lut.values_t.shape
    got = b6.winlut_lookup(lut.values_t, xi, yi, t, lut.miss, 1.0, tile, tblk)
    want = b6.winlut_lookup_reference(lut.values_t, xi, yi, t, lut.miss, 1.0, tile, tblk)
    torch.cuda.synchronize()
    n = xi.numel()
    label = f"{n} particles, [{k}, {wx}, {wy}] bf16, tile {tile}, tblk {tblk}"
    miss_got, miss_want = got == lut.miss, want == lut.miss
    check(torch.equal(miss_got, miss_want),
          f"B6 {label}: {int((miss_got != miss_want).sum())} particles differ in the miss set")
    check(bool(torch.isfinite(got).all()), "B6 weights not finite")
    check(torch.allclose(got, want, rtol=1e-6, atol=0),
          f"B6 {label}: max rel err {float(((got - want).abs() / want).max()):.3g} > 1e-6")
    t_lo = b6.slab_bases(F.pad(t, (0, -n % tile), value=-1.0), k, min(tblk, k), tile)
    slabs = int(torch.unique(t_lo).numel())
    check(slabs > 1, f"B6 {label}: the cloud's tiles share one slab")
    check(0 < int(miss_got.sum()) < n // 10, f"B6 {label}: {int(miss_got.sum())} misses")
    vol = lut.values_t.float()[None, None].contiguous()  # [1, 1, K, Wx, Wy]
    grid = torch.stack([2 * yi / (wy - 1) - 1, 2 * xi / (wx - 1) - 1, 2 * t / (k - 1) - 1],
                       -1)[None, None, None].contiguous()  # (W, H, D) = (y, x, θ)

    def library():
        return F.grid_sample(vol, grid, mode="bilinear", align_corners=True)

    lib = 1.0 + library().reshape(-1)
    hit = ~miss_got
    lib_rel = float(((lib[hit] - got[hit]).abs() / got[hit]).max())
    check(lib_rel < 1e-3, f"B6 {label}: grid_sample differs by {lib_rel:.3g} where B6 scores")
    times = timings(lambda: b6.winlut_lookup(lut.values_t, xi, yi, t, lut.miss, 1.0, tile, tblk),
                    lambda: b6.winlut_lookup_reference(lut.values_t, xi, yi, t, lut.miss, 1.0,
                                                       tile, tblk),
                    iters, library=library)
    bms, by = bound_ms(16 * n + 2 * lut.values_t.numel(), B6_OPS_PER_PARTICLE * int(hit.sum()))
    return dict(
        name="B6 winlut_lookup", route="cuda", source="beluga_tpu_torch/csrc/winlut.cu",
        replaces="beluga_tpu/ops/pallas_winlut.py:157", max_abs_err=float((got - want).abs().max()),
        bound_ms=bms, bound_by=by, shape=label, slabs=slabs, misses=int(miss_got.sum()),
        grid_sample_max_rel=lib_rel, **times,
    )


def near_edge(xo, yo, co, so, scalars, k: int, wx: int, wy: int, tile: int):
    """Particles whose float64 window coordinates (recomputed from the
    plain version's outputs) lie within EDGE of a window or bin edge, or in
    a tile whose minimum bin does."""
    from beluga_tpu_torch.ops import cuda_fused_step as b5

    sc = scalars.double()
    x, y, c, s = (v.double() for v in (xo, yo, co, so))
    xf = (sc[b5.WF_C] * x - sc[b5.WF_S] * y + sc[b5.WF_X]) * sc[b5.INV_RES] + sc[b5.OFF_X]
    yf = (sc[b5.WF_S] * x + sc[b5.WF_C] * y + sc[b5.WF_Y]) * sc[b5.INV_RES] + sc[b5.OFF_Y]
    rel = torch.remainder(torch.atan2(s, c) + sc[b5.T_ANG] + math.pi, 2 * math.pi) - math.pi
    t = rel * sc[b5.INV_DTH] + sc[b5.T_BIAS]
    frac = (t - torch.round(t)).abs()
    near = ((xf.abs() < EDGE) | ((xf - (wx - 1)).abs() < EDGE) | (yf.abs() < EDGE)
            | ((yf - (wy - 1)).abs() < EDGE) | (frac < EDGE))
    n = t.numel()
    pad = -n % tile
    tt = torch.nn.functional.pad(t, (0, pad), value=-1.0).reshape(-1, tile)
    ft = torch.nn.functional.pad(frac, (0, pad), value=1.0).reshape(-1, tile)
    arg = torch.where((tt >= 0) & (tt < k), tt, torch.inf).argmin(dim=1)
    tile_near = ft.gather(1, arg[:, None]) < EDGE
    return near | tile_near.expand(-1, tile).reshape(-1)[:n]


def check_fused_step(n: int, dev, iters: int) -> dict:
    """Kernel B5 at the mega geometry (2097152 particles, 20 bins, a 32x128
    window, tile 4096, tblk 20) on the workload's cloud with strays, the
    motion of its first step, fresh normals: states within 1e-5 of its
    plain version, log-likelihoods within 1e-5, miss sets equal except
    within EDGE of an edge (counted)."""
    from beluga_tpu_torch.filters.amcl import host_pose
    from beluga_tpu_torch.filters.builders import fused_step_scalars
    from beluga_tpu_torch.ops import cuda_fused_step as b5
    from beluga_tpu_torch.tools import workloads

    from beluga_tpu_torch.models.motion.differential_drive import DifferentialDriveParams

    cfg = workloads.MEGA_FILTER
    w = workloads.mega(2, dev)
    states, lut = window_inputs(w, cfg)
    s = w.scans
    scalars = fused_step_scalars(lut, DifferentialDriveParams(),
                                 host_pose(s.xs[1], s.ys[1], s.yaws[1]),
                                 host_pose(s.xs[0], s.ys[0], s.yaws[0]), dev)
    tile, tblk = cfg["tile"], cfg["tblk"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    z = torch.randn((3, n), generator=gen, device=dev)
    planes = [v[:n].contiguous() for v in (states.x, states.y, states.theta)]
    args = (*planes, z, lut.values_t, scalars)
    got = b5.fused_propagate_winlut(*args, tile=tile, tblk=tblk)
    want = b5.fused_propagate_winlut_reference(*args, tile=tile, tblk=tblk)
    torch.cuda.synchronize()
    k, wx, wy = lut.values_t.shape
    label = f"{n} particles, [{k}, {wx}, {wy}] bf16, tile {tile}, tblk {tblk}"
    for g, x, what in zip(got, want, ("x'", "y'", "cos'", "sin'", "log_lik")):
        check(bool(torch.isfinite(g).all()), f"B5 {label}: {what} not finite")
    state_err = max(float((g - x).abs().max()) for g, x in zip(got[:4], want[:4]))
    check(state_err <= 1e-5, f"B5 {label}: states differ by {state_err:.3g} > 1e-5")
    miss_lw = torch.log(lut.miss)
    miss_got, miss_want = got[4] == miss_lw, want[4] == miss_lw
    near = near_edge(*want[:4], scalars, k, wx, wy, tile)
    flips = miss_got != miss_want
    check(not bool((flips & ~near).any()),
          f"B5 {label}: {int((flips & ~near).sum())} miss flips away from an edge")
    both = ~miss_got & ~miss_want
    lw_err = float((got[4][both] - want[4][both]).abs().max())
    check(lw_err <= 1e-5, f"B5 {label}: log-likelihoods differ by {lw_err:.3g} > 1e-5")
    check(0 < int(miss_got.sum()) < n // 2, f"B5 {label}: {int(miss_got.sum())} misses")
    times = timings(lambda: b5.fused_propagate_winlut(*args, tile=tile, tblk=tblk),
                    lambda: b5.fused_propagate_winlut_reference(*args, tile=tile, tblk=tblk),
                    iters)
    bms, by = bound_ms(44 * n + 2 * lut.values_t.numel(), B5_OPS_PER_PARTICLE * n)
    return dict(
        name="B5 fused_propagate_winlut", route="cuda", source="beluga_tpu_torch/csrc/winlut.cu",
        replaces="beluga_tpu/ops/pallas_fused_step.py:169",
        max_abs_err=max(state_err, lw_err), bound_ms=bms, bound_by=by, shape=label,
        misses=int(miss_got.sum()), miss_flips=int(flips.sum()),
        near_edge=int(near.sum()), **times,
    )


def beam_scan(points: torch.Tensor):
    """Measured ranges, unit bearings and bearing angles of a scan's points."""
    px, py = points[..., 0], points[..., 1]
    z = torch.sqrt(px * px + py * py)
    return z, points / torch.clamp_min(z, 1e-12)[..., None], torch.atan2(py, px)


def arena_cloud(n: int, dev, seed: int, batch: int | None = None, stray_every: int = 0):
    """``n`` particles about the arena's first pose (sd 0.3 m, 0.2 rad),
    θ-sorted, every ``stray_every``-th moved 5 m off; one filter or
    ``batch``."""
    from beluga_tpu_torch.lie import SE2
    from beluga_tpu_torch.tools.workloads import arena_scans

    s = arena_scans(1)
    lead = () if batch is None else (batch,)
    rng = np.random.default_rng(seed)
    xyt = rng.normal([s.xs[0], s.ys[0], s.yaws[0]], [0.3, 0.3, 0.2], (*lead, n, 3))
    xyt = np.take_along_axis(xyt, np.argsort(xyt[..., 2:], axis=-2, kind="stable"), axis=-2)
    if stray_every:
        xyt[..., ::stray_every, :2] += 5.0
    return SE2.from_xytheta(*(torch.as_tensor(xyt[..., i], dtype=torch.float32)
                              for i in range(3)), device=dev), s


def check_raycast(dev, iters: int, lut_build: bool) -> dict:
    """Kernel R1 at the beam node's 2000 x 60 rays at 100 m (the exact
    path), or at the range-LUT build's 128 x 384 x 384 rays at 4 m: hit
    flags and distances bit-equal to its plain version, both variants."""
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.ops import raycast as r1
    from beluga_tpu_torch.tools import workloads

    grid = make_grid(workloads.arena_scans(1).data, workloads.RES, device=dev)
    if lut_build:
        k, h, w = workloads.BEAM_FLEET["n_bearings"], grid.height, grid.width
        max_range = workloads.BEAM_FLEET["beam_max_range"]
        res = torch.tensor(grid.resolution, dtype=torch.float32, device=dev)
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * res
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * res
        src = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)], -1)[None]
        th = torch.arange(k, dtype=torch.float32, device=dev) * (2.0 * math.pi / k)
        dirs = torch.stack([torch.cos(th), torch.sin(th)], -1)[:, None, None, :]
        label = f"{k}x{h}x{w} rays (range-LUT build, {max_range} m)"
        plain_iters = 2
    else:
        states, s = arena_cloud(2000, dev, seed=11)
        _, bearing, _ = beam_scan(torch.as_tensor(s.points[0]).to(dev))
        c, sn = states.rot.cos[:, None], states.rot.sin[:, None]
        bx, by = bearing[None, :, 0], bearing[None, :, 1]
        src = states.xy[:, None, :]
        dirs = torch.stack([c * bx - sn * by, sn * bx + c * by], -1)
        max_range = 100.0
        label = f"2000x{bearing.shape[0]} rays (beam node, {max_range} m)"
        plain_iters = 3
    src, dirs = (v.contiguous() for v in torch.broadcast_tensors(src, dirs))
    steps = r1.num_steps(max_range, grid.resolution)
    err, casts = 0.0, {}
    for variant in r1.VARIANTS:
        got = casts[variant] = r1.cast_rays(grid, src, dirs, max_range, variant=variant)
        want = r1.cast_rays_reference(grid.free_mask, src, dirs, max_range, grid.resolution,
                                      steps, variant)
        torch.cuda.synchronize()
        check(torch.equal(got[1], want[1]),
              f"R1 {variant} {label}: {int((got[1] != want[1]).sum())} hit flags differ")
        check(torch.equal(got[0], want[0]),
              f"R1 {variant} {label}: {int((got[0] != want[0]).sum())} distances differ")
        err = max(err, float((got[0] - want[0]).abs().max()))
    dist, hit = casts["standard"]
    check(0 < int(hit.sum()) < hit.numel() or lut_build, f"R1 {label}: no hits or no misses")
    # cells visited: up to the hit cell, else to the far cell
    x0, y0, x1, y1 = r1.line_ends(src, dirs, max_range, grid.resolution)
    span = torch.maximum((x1 - x0).abs(), (y1 - y0).abs()).float()
    cells = float(torch.where(hit, torch.round(dist / grid.resolution), span).sum() + hit.numel())
    times = timings(lambda: r1.cast_rays(grid, src, dirs, max_range),
                    lambda: r1.cast_rays_reference(grid.free_mask, src, dirs, max_range,
                                                   grid.resolution, steps, "standard"),
                    iters, plain_iters=plain_iters)
    n = hit.numel()
    bms, by = bound_ms(21 * n + grid.height * grid.width, R1_OPS_PER_CELL * cells)
    return dict(
        name="R1 cast_rays", route="cuda", source="beluga_tpu_torch/csrc/raycast.cu",
        replaces="beluga_tpu/ops/raycast.py:33 (no Pallas kernel)", max_abs_err=err,
        bound_ms=bms, bound_by=by, shape=label, cells_visited=cells, hits=int(hit.sum()),
        **times,
    )


def check_sphere_trace(dev, iters: int, long_range: bool) -> dict:
    """Kernel B8 at the beam node's 2000 x 60 on the arena at 100 m (89
    steps), or the long-range filter's 2048 x 60 on the 1024² map at 60 m
    (48 steps): weights bit-equal to its plain version (same operations in
    the same order), finite."""
    from beluga_tpu_torch.filters.builders import sphere_trace_steps
    from beluga_tpu_torch.io import synthetic
    from beluga_tpu_torch.lie import SE2
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.models.sensor.beam import BeamModelParams
    from beluga_tpu_torch.ops import cuda_beam as b8
    from beluga_tpu_torch.tools import workloads

    if long_range:
        cfg = workloads.LONG_RANGE
        data = synthetic.long_range_world(cfg["cells"])
        xs, ys, yaws = synthetic.arc_trajectory(1, cfg["cells"], cfg["res"])
        pts, mask = synthetic.simulate_scans(data, cfg["res"], xs, ys, yaws, workloads.BEAMS,
                                             max_range=cfg["beam_max_range"])
        grid = make_grid(data, cfg["res"], device=dev)
        params = BeamModelParams(beam_max_range=cfg["beam_max_range"], sigma_hit=cfg["sigma_hit"])
        rng = np.random.default_rng(12)
        xyt = rng.normal([xs[0], ys[0], yaws[0]], [0.5, 0.5, 0.2], (cfg["n"], 3))
        states = SE2.from_xytheta(*(torch.as_tensor(xyt[:, i], dtype=torch.float32)
                                    for i in range(3)), device=dev)
        label = f"{cfg['n']}x{workloads.BEAMS}, 1024² at 0.1 m, {params.beam_max_range} m"
    else:
        states, s = arena_cloud(2000, dev, seed=13)
        pts, mask = s.points, s.mask
        grid = make_grid(s.data, workloads.RES, device=dev)
        params = workloads.node_config(s, laser_model_type="beam").beam_params()
        label = f"2000x{workloads.BEAMS}, arena, {params.beam_max_range} m"
    steps = sphere_trace_steps(params.beam_max_range, grid.resolution)
    label += f", {steps} steps"
    dist = b8.make_distance_cells(grid.free_mask)
    z, bearing, _ = beam_scan(torch.as_tensor(pts[0]).to(dev))
    beams = torch.as_tensor(mask[0]).to(dev)
    pv = (params.beam_max_range, params.z_hit, params.z_short, params.z_max, params.z_rand,
          params.sigma_hit, params.lambda_short)
    poses = [v.contiguous() for v in (states.x, states.y, states.rot.cos, states.rot.sin)]
    args = (dist, *poses, bearing.contiguous(), z.contiguous(), beams, grid.resolution, pv)
    got = b8.sphere_trace_beam_weights(*args, march_steps=steps)
    want = b8.sphere_trace_reference(*args, march_steps=steps)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"B8 {label}: weights not finite")
    check(torch.equal(got, want),
          f"B8 {label}: {int((got != want).sum())} weights differ from the plain version")
    traced = b8.trace_steps(dist, *poses, bearing, beams, grid.resolution, pv, steps)
    times = timings(lambda: b8.sphere_trace_beam_weights(*args, march_steps=steps),
                    lambda: b8.sphere_trace_reference(*args, march_steps=steps), iters,
                    plain_iters=5)
    n, unmasked = poses[0].numel(), int(beams.sum())
    bms, by = bound_ms(20 * n + 13 * beams.numel() + dist.numel(),
                       B8_OPS_PER_BEAM * n * unmasked + B8_OPS_PER_STEP * traced)
    return dict(
        name="B8 sphere_trace_beam_weights", route="cuda", source="beluga_tpu_torch/csrc/beam.cu",
        replaces="beluga_tpu/ops/pallas_beam.py:188", max_abs_err=float((got - want).abs().max()),
        bound_ms=bms, bound_by=by, shape=label, trace_steps=traced, **times,
    )


def check_beam_lut(dev, iters: int) -> dict:
    """Kernel B7 at the beam fleet's geometry: 64 filters x 4096 θ-sorted
    particles x 60 beams, K = 128 at 4 m, every 50th slot a stray 5 m off
    (all-miss): weights bit-equal to its plain version, the strays scoring
    the LUT's max range in every bin."""
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.models.sensor.beam import BeamModelParams
    from beluga_tpu_torch.models.sensor.beam_lut import build_range_lut, lut_cells
    from beluga_tpu_torch.ops import cuda_beam_lut as b7
    from beluga_tpu_torch.tools import workloads

    cfg = workloads.BEAM_FLEET
    states, s = arena_cloud(FLEET_N, dev, seed=14, batch=FLEET_B, stray_every=50)
    lut = build_range_lut(make_grid(s.data, workloads.RES, device=dev), cfg["beam_max_range"],
                          cfg["n_bearings"])
    table = b7.build_lut_bf16(lut.ranges)
    local, xi, yi = lut_cells(lut, states)
    z, _, beta = beam_scan(torch.as_tensor(s.points[0]).to(dev))
    beams = torch.as_tensor(s.mask[0]).to(dev)
    p = BeamModelParams(beam_max_range=cfg["beam_max_range"])
    mix = (p.z_hit, p.z_short, p.z_rand, p.z_max, p.sigma_hit, p.lambda_short, p.beam_max_range)
    lead = (FLEET_B, workloads.BEAMS)
    args = (table, local.theta.contiguous(), xi, yi, z.expand(lead).contiguous(),
            beta.expand(lead).contiguous(), beams.expand(lead).contiguous(), lut.max_range, mix)
    got, want = b7.beam_lut_windowed(*args), b7.beam_lut_windowed_reference(*args)
    torch.cuda.synchronize()
    label = f"{FLEET_B}x{FLEET_N}x{workloads.BEAMS}, K={cfg['n_bearings']}, bf16{list(table.shape)}"
    check(bool(torch.isfinite(got).all()), f"B7 {label}: weights not finite")
    check(torch.equal(got, want),
          f"B7 {label}: {int((got != want).sum())} weights differ from the plain version")
    hq, wq, k = table.shape
    origins = b7.window_origins(xi, yi, hq, wq)
    slot = torch.arange(FLEET_N, device=dev)
    o = origins[:, slot // b7.TILE, (slot % b7.TILE >= b7.BLOCKS[1][0]).long()]
    covered = ((xi >= o[..., 0]) & (xi < o[..., 0] + b7.CWX) & (yi >= o[..., 1])
               & (yi < o[..., 1] + b7.CWY))
    strays = ~covered
    check(bool(strays[:, ::50].all()) and int(strays.sum()) < covered.numel() // 10,
          f"B7 {label}: {int(strays.sum())} particles outside their windows")
    all_miss = b7.beam_lut_windowed_reference(
        torch.full_like(table, lut.max_range), *args[1:])
    check(torch.equal(got[strays], all_miss[strays]), f"B7 {label}: strays do not read max range")
    times = timings(lambda: b7.beam_lut_windowed(*args),
                    lambda: b7.beam_lut_windowed_reference(*args), iters, plain_iters=5)
    cells = int(torch.unique((yi * wq + xi)[covered]).numel())
    total, unmasked = xi.numel(), int(beams.sum()) * FLEET_B
    bms, by = bound_ms(16 * total + 9 * FLEET_B * workloads.BEAMS + 2 * k * cells,
                       B7_OPS_PER_BEAM * FLEET_N * unmasked)
    return dict(
        name="B7 beam_lut_windowed", route="cuda", source="beluga_tpu_torch/csrc/beam_lut.cu",
        replaces="beluga_tpu/ops/pallas_beam_lut.py:342", max_abs_err=float((got - want).abs().max()),
        bound_ms=bms, bound_by=by, shape=label, strays=int(strays.sum()), lut_cells_read=cells,
        **times,
    )


# -- phases 4 to 11: the main paths --------------------------------------------


def reset_counts() -> None:
    from beluga_tpu_torch.ops import (
        cuda_beam,
        cuda_beam_lut,
        cuda_fused_step,
        cuda_pool_take,
        cuda_resample,
        cuda_reweight,
        cuda_winlut,
        raycast,
    )

    cuda_reweight.launches = 0
    cuda_reweight.values3_launches = 0
    cuda_resample.launches = 0
    cuda_pool_take.launches = 0
    cuda_winlut.launches = 0
    cuda_fused_step.launches = 0
    cuda_beam_lut.launches = 0
    cuda_beam.launches = 0
    raycast.launches = 0


def read_counts() -> dict:
    from beluga_tpu_torch.ops import (
        cuda_beam,
        cuda_beam_lut,
        cuda_fused_step,
        cuda_pool_take,
        cuda_resample,
        cuda_reweight,
        cuda_winlut,
        raycast,
    )

    return {"B1 fused_reweight": cuda_reweight.launches,
            "B2 resample_take": cuda_resample.launches,
            "B3 pool_take": cuda_pool_take.launches,
            "B4 fused_reweight values3": cuda_reweight.values3_launches,
            "B5 fused_propagate_winlut": cuda_fused_step.launches,
            "B6 winlut_lookup": cuda_winlut.launches,
            "B7 beam_lut_windowed": cuda_beam_lut.launches,
            "B8 sphere_trace_beam_weights": cuda_beam.launches,
            "R1 cast_rays": raycast.launches}


def run_node(dev, scans: int = NODE_SCANS, what: str = "node",
             must_launch=("B1 fused_reweight", "B2 resample_take"),
             **overrides) -> tuple[dict, dict]:
    """The node at nav2 defaults (``overrides`` of ``AmclNodeConfig``
    fields select the beam node) for ``scans`` scans; the launch counts
    cover the map load and every scan, and each kernel of ``must_launch``
    must have been launched."""
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.node import AmclNode
    from beluga_tpu_torch.tools import workloads

    s = workloads.arena_scans(scans)
    reset_counts()
    t0 = time.perf_counter()
    node = AmclNode(workloads.node_config(s, **overrides), seed=0, device=dev)
    node.set_map(make_grid(s.data, workloads.RES, device=dev))
    torch.cuda.synchronize()
    set_map_s = time.perf_counter() - t0
    times, worst_pos, worst_yaw, valid = [], 0.0, 0.0, 0
    for t in range(scans):
        t0 = time.perf_counter()
        r = node.handle_scan((s.xs[t], s.ys[t], s.yaws[t]), s.points[t], s.mask[t])
        times.append(time.perf_counter() - t0)
        if not r.valid:
            continue
        valid += 1
        check(bool(np.isfinite(r.pose).all() and np.isfinite(r.covariance[:2, :2]).all()),
              f"{what} scan {t}: estimate not finite")
        e_pos = math.hypot(r.pose[0] - s.xs[t], r.pose[1] - s.ys[t])
        e_yaw = yaw_error(r.pose[2], s.yaws[t])
        worst_pos, worst_yaw = max(worst_pos, e_pos), max(worst_yaw, e_yaw)
        check(e_pos < GATE_POS_M and e_yaw < GATE_YAW_RAD,
              f"{what} scan {t}: error {e_pos:.3f} m / {math.degrees(e_yaw):.1f} deg")
    counts = read_counts()
    check(valid >= scans - 1, f"{what}: only {valid} valid updates of {scans}")
    for name in must_launch:
        check(counts[name] > 0, f"{what}: {name} was never launched")
    steady = sorted(times[2:])
    return counts, dict(
        scans=scans, valid=valid, set_map_s=set_map_s, worst_pos_m=worst_pos,
        worst_yaw_deg=math.degrees(worst_yaw),
        ms_per_update_median=1e3 * steady[len(steady) // 2],
        ms_per_update_mean=1e3 * sum(steady) / len(steady),
        ms_first_update=1e3 * times[0],
        active_particles=int(node._state.particles.active),
    )


def run_large_filter(dev, n: int = LARGE_N, n_min: int = LARGE_MIN,
                     scans: int = LARGE_SCANS) -> tuple[dict, dict]:
    from beluga_tpu_torch.filters.amcl import host_pose, update
    from beluga_tpu_torch.tools import workloads

    w = workloads.large_filter(scans, dev, n, n_min)
    s, state = w.scans, w.state
    reset_counts()
    times, worst_pos, worst_yaw, active = [], 0.0, 0.0, []
    for t in range(scans):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, est = update(w.params, w.models, w.ctx, state,
                            host_pose(s.xs[t], s.ys[t], s.yaws[t]), w.points[t], w.mask[t])
        pose = est.pose.as_xytheta().cpu().numpy()
        times.append(time.perf_counter() - t0)
        check(est.valid, f"large filter scan {t}: update gated out")
        check(bool(np.isfinite(pose).all()), f"large filter scan {t}: estimate not finite")
        e_pos = math.hypot(pose[0] - s.xs[t], pose[1] - s.ys[t])
        e_yaw = yaw_error(float(pose[2]), s.yaws[t])
        worst_pos, worst_yaw = max(worst_pos, e_pos), max(worst_yaw, e_yaw)
        check(e_pos < GATE_POS_M and e_yaw < GATE_YAW_RAD,
              f"large filter scan {t}: error {e_pos:.3f} m / {math.degrees(e_yaw):.1f} deg")
        active.append(int(state.particles.active))
    counts = read_counts()
    for name in ("B1 fused_reweight", "B2 resample_take", "B3 pool_take"):
        check(counts[name] > 0, f"large filter: {name} was never launched")
    steady = times[2:]
    mean_s = sum(steady) / len(steady)
    return counts, dict(
        particles=n, scans=scans, worst_pos_m=worst_pos,
        worst_yaw_deg=math.degrees(worst_yaw), ms_per_update_mean=1e3 * mean_s,
        particle_updates_per_s=n / mean_s, active_last=active[-1],
    )


def run_fleet(dev, b: int = FLEET_B, n: int = FLEET_N,
              scans: int = FLEET_SCANS) -> tuple[dict, dict]:
    """The JAX benchmark's fleet (bench.py:46-49, :180-220): B filters of N
    particles, codebook16, theta-sorted slots, fixed count, multinomial
    resampling, pooled recovery; every filter scores the same scan."""
    from beluga_tpu_torch.parallel.fleet import make_fleet_update
    from beluga_tpu_torch.tools import workloads

    w = workloads.fleet(scans, dev, b, n)
    s, state = w.scans, w.state
    fleet_update = make_fleet_update(w.params, w.models)
    reset_counts()
    times, worst_pos, worst_yaw = [], 0.0, 0.0
    for t in range(scans):
        odoms = workloads.fleet_odometry(s, t, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, est = fleet_update(w.ctx, state, odoms, w.points[t], w.mask[t])
        pose = est.pose.as_xytheta().cpu().numpy()  # [b, 3], the one readback
        times.append(time.perf_counter() - t0)
        check(bool(np.all(est.valid)), f"fleet scan {t}: a filter was gated out")
        check(bool(np.isfinite(pose).all()), f"fleet scan {t}: estimate not finite")
        e_pos = np.hypot(pose[:, 0] - s.xs[t], pose[:, 1] - s.ys[t])
        e_yaw = np.abs(np.arctan2(np.sin(pose[:, 2] - s.yaws[t]), np.cos(pose[:, 2] - s.yaws[t])))
        worst_pos, worst_yaw = max(worst_pos, float(e_pos.max())), max(worst_yaw, float(e_yaw.max()))
        check(bool((e_pos < GATE_POS_M).all() and (e_yaw < GATE_YAW_RAD).all()),
              f"fleet scan {t}: worst filter {e_pos.max():.3f} m / "
              f"{math.degrees(e_yaw.max()):.1f} deg")
    counts = read_counts()
    for name in ("B2 resample_take", "B3 pool_take", "B4 fused_reweight values3"):
        check(counts[name] == scans,
              f"fleet: {name} launched {counts[name]} times in {scans} updates")
    check(counts["B1 fused_reweight"] == 0, "fleet: B1 launched in codebook16 mode")
    steady = sorted(times[2:])
    mean_s = sum(steady) / len(steady)
    return counts, dict(
        filters=b, particles=n, scans=scans, worst_pos_m=worst_pos,
        worst_yaw_deg=math.degrees(worst_yaw), ms_per_update_mean=1e3 * mean_s,
        ms_per_update_median=1e3 * steady[len(steady) // 2],
        ms_first_update=1e3 * times[0], particle_updates_per_s=b * n / mean_s,
    )


def run_forced(w, scans: int, what: str, sort_every: int | None = None):
    """Step a single filter with ``force_update`` on every scan (and
    ``sort_now`` on every ``sort_every``-th): the gate on every scan, the
    launch counts, wall times and errors."""
    from beluga_tpu_torch.filters.amcl import host_pose, update

    s, state = w.scans, w.state
    reset_counts()
    times, errs, yaws = [], [], []
    for t in range(scans):
        sort_now = None if sort_every is None else t % sort_every == 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, est = update(w.params, w.models, w.ctx, state._replace(force_update=True),
                            host_pose(s.xs[t], s.ys[t], s.yaws[t]), w.points[t], w.mask[t],
                            sort_now=sort_now)
        pose = est.pose.as_xytheta().cpu().numpy()
        times.append(time.perf_counter() - t0)
        check(est.valid, f"{what} scan {t}: update gated out")
        check(bool(np.isfinite(pose).all()), f"{what} scan {t}: estimate not finite")
        errs.append(math.hypot(pose[0] - s.xs[t], pose[1] - s.ys[t]))
        yaws.append(yaw_error(float(pose[2]), s.yaws[t]))
        check(errs[-1] < GATE_POS_M and yaws[-1] < GATE_YAW_RAD,
              f"{what} scan {t}: error {errs[-1]:.3f} m / {math.degrees(yaws[-1]):.1f} deg")
    counts = read_counts()
    n = w.params.max_particles
    steady = sorted(times[2:])
    mean_s = sum(steady) / len(steady)
    return counts, errs, dict(
        particles=n, scans=scans, err_mean_m=float(np.mean(errs)), err_max_m=max(errs),
        worst_yaw_deg=math.degrees(max(yaws)), ms_per_update_mean=1e3 * mean_s,
        ms_per_update_median=1e3 * steady[len(steady) // 2], ms_first_update=1e3 * times[0],
        particle_updates_per_s=n / mean_s,
    )


def run_mega(dev, scans: int = MEGA_SCANS, n: int | None = None) -> tuple[dict, dict]:
    """The JAX benchmark's headline mega filter (bench.py:247-386)."""
    from beluga_tpu_torch.tools import workloads

    w = workloads.mega(scans, dev, **({} if n is None else {"n": n}))
    counts, errs, out = run_forced(w, scans, "mega", workloads.MEGA_SORT_EVERY)
    last = errs[-MEGA_LAST:]
    out.update(err_mean_last_m=float(np.mean(last)), err_max_last_m=max(last))
    check(max(last) <= MEGA_LAST_GATE_M,
          f"mega: max error {max(last):.3f} m over the last {MEGA_LAST} scans > "
          f"{MEGA_LAST_GATE_M} m")
    check(counts["B5 fused_propagate_winlut"] == scans,
          f"mega: B5 launched {counts['B5 fused_propagate_winlut']} times in {scans} updates")
    for name in ("B1 fused_reweight", "B4 fused_reweight values3", "B6 winlut_lookup"):
        check(counts[name] == 0, f"mega: {name} launched {counts[name]} times")
    return counts, out


def run_windowed(dev, scans: int = WINDOWED_SCANS) -> tuple[dict, dict]:
    """The coverage-gated windowed filter (bench.py:880-900)."""
    from beluga_tpu_torch.tools import workloads

    w = workloads.windowed(scans, dev)
    counts, _, out = run_forced(w, scans, "windowed")
    fast = counts["B6 winlut_lookup"]
    check(fast >= 1, "windowed: B6 was never launched")
    check(counts["B1 fused_reweight"] == scans,
          f"windowed: B1 launched {counts['B1 fused_reweight']} times in {scans} updates")
    out.update(fast_updates=fast, exact_updates=scans - fast)
    return counts, out


def run_beam_node(dev, mode: str) -> tuple[dict, dict]:
    """The beam node at nav2 defaults (100 m) in ``beam_fast_path=mode``."""
    counts, out = run_node(dev, BEAM_NODE_SCANS, f"beam node {mode}", ("B2 resample_take",),
                           laser_model_type="beam", beam_fast_path=mode)
    updates = out["valid"]
    expected = {  # launches of each beam kernel: the map load and every update
        "exact": {"R1 cast_rays": updates, "B7 beam_lut_windowed": 0,
                  "B8 sphere_trace_beam_weights": 0},
        "lut": {"R1 cast_rays": 1, "B7 beam_lut_windowed": 0, "B8 sphere_trace_beam_weights": 0},
        "windowed": {"R1 cast_rays": 1, "B7 beam_lut_windowed": updates,
                     "B8 sphere_trace_beam_weights": 0},
        "sphere_trace": {"R1 cast_rays": 0, "B7 beam_lut_windowed": 0,
                         "B8 sphere_trace_beam_weights": updates},
    }[mode]
    for name, want in {**expected, "B1 fused_reweight": 0}.items():
        check(counts[name] == want,
              f"beam node {mode}: {name} launched {counts[name]} times, expected {want}")
    return counts, out


def run_long_range(dev, scans: int = LONG_RANGE_SCANS) -> tuple[dict, dict]:
    """The long-range sphere-trace filter (benchmarks/REPORT.md:175-185):
    every scan after the warm-up within the gate, B8 once per update."""
    from beluga_tpu_torch.filters.amcl import host_pose, update
    from beluga_tpu_torch.tools import workloads

    w = workloads.long_range(scans, dev)
    s, state = w.scans, w.state
    reset_counts()
    times, errs, yaws = [], [], []
    for t in range(scans):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, est = update(w.params, w.models, w.ctx, state._replace(force_update=True),
                            host_pose(s.xs[t], s.ys[t], s.yaws[t]), w.points[t], w.mask[t])
        pose = est.pose.as_xytheta().cpu().numpy()
        times.append(time.perf_counter() - t0)
        check(est.valid, f"long range scan {t}: update gated out")
        check(bool(np.isfinite(pose).all()), f"long range scan {t}: estimate not finite")
        errs.append(math.hypot(pose[0] - s.xs[t], pose[1] - s.ys[t]))
        yaws.append(yaw_error(float(pose[2]), s.yaws[t]))
        if t >= LONG_RANGE_WARMUP:
            check(errs[-1] < GATE_POS_M and yaws[-1] < GATE_YAW_RAD,
                  f"long range scan {t}: error {errs[-1]:.3f} m / "
                  f"{math.degrees(yaws[-1]):.1f} deg")
    counts = read_counts()
    check(counts["B8 sphere_trace_beam_weights"] == scans,
          f"long range: B8 launched {counts['B8 sphere_trace_beam_weights']} times in "
          f"{scans} updates")
    for name in ("B1 fused_reweight", "R1 cast_rays", "B7 beam_lut_windowed"):
        check(counts[name] == 0, f"long range: {name} launched {counts[name]} times")
    hits = s.mask[LONG_RANGE_WARMUP:]
    ranges = np.hypot(s.points[..., 0], s.points[..., 1])[LONG_RANGE_WARMUP:][hits]
    steady = sorted(times[2:])
    mean_s = sum(steady) / len(steady)
    gated = errs[LONG_RANGE_WARMUP:]
    return counts, dict(
        particles=w.params.max_particles, scans=scans, err_mean_m=float(np.mean(gated)),
        err_max_m=max(gated), worst_yaw_deg=math.degrees(max(yaws[LONG_RANGE_WARMUP:])),
        mean_hit_range_m=float(ranges.mean()), ms_per_update_mean=1e3 * mean_s,
        ms_per_update_median=1e3 * steady[len(steady) // 2], ms_first_update=1e3 * times[0],
        particle_updates_per_s=w.params.max_particles / mean_s,
    )


def run_beam_fleet(dev, b: int = FLEET_B, n: int = FLEET_N,
                   scans: int = BEAM_FLEET_SCANS) -> tuple[dict, dict]:
    """The windowed beam fleet (bench.py:678-720): every filter within the
    gate, B7 once per update, B1 and B4 never, R1 in the LUT build."""
    from beluga_tpu_torch.parallel.fleet import make_fleet_update
    from beluga_tpu_torch.tools import workloads

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w = workloads.beam_fleet(scans, dev, b, n)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    s, state = w.scans, w.state
    fleet_update = make_fleet_update(w.params, w.models)
    times, worst_pos, worst_yaw = [], 0.0, 0.0
    for t in range(scans):
        odoms = workloads.fleet_odometry(s, t, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, est = fleet_update(w.ctx, state, odoms, w.points[t], w.mask[t])
        pose = est.pose.as_xytheta().cpu().numpy()
        times.append(time.perf_counter() - t0)
        check(bool(np.all(est.valid)), f"beam fleet scan {t}: a filter was gated out")
        check(bool(np.isfinite(pose).all()), f"beam fleet scan {t}: estimate not finite")
        e_pos = np.hypot(pose[:, 0] - s.xs[t], pose[:, 1] - s.ys[t])
        e_yaw = np.abs(np.arctan2(np.sin(pose[:, 2] - s.yaws[t]), np.cos(pose[:, 2] - s.yaws[t])))
        worst_pos, worst_yaw = max(worst_pos, float(e_pos.max())), max(worst_yaw, float(e_yaw.max()))
        check(bool((e_pos < GATE_POS_M).all() and (e_yaw < GATE_YAW_RAD).all()),
              f"beam fleet scan {t}: worst filter {e_pos.max():.3f} m / "
              f"{math.degrees(e_yaw.max()):.1f} deg")
    counts = read_counts()
    check(counts["B7 beam_lut_windowed"] == scans,
          f"beam fleet: B7 launched {counts['B7 beam_lut_windowed']} times in {scans} updates")
    check(counts["R1 cast_rays"] >= 1, "beam fleet: R1 was not launched by the LUT build")
    for name in ("B1 fused_reweight", "B4 fused_reweight values3"):
        check(counts[name] == 0, f"beam fleet: {name} launched {counts[name]} times")
    steady = sorted(times[2:])
    mean_s = sum(steady) / len(steady)
    return counts, dict(
        filters=b, particles=n, scans=scans, lut_build_s=build_s, worst_pos_m=worst_pos,
        worst_yaw_deg=math.degrees(worst_yaw), ms_per_update_mean=1e3 * mean_s,
        ms_per_update_median=1e3 * steady[len(steady) // 2], ms_first_update=1e3 * times[0],
        particle_updates_per_s=b * n / mean_s,
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2
    import beluga_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from beluga_tpu_torch.ops import _build
    from beluga_tpu_torch.tools import workloads

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
    k_main, w = check_reweight(2000, dev, iters=200)
    r_main = check_resample(2000, w, dev, iters=200)
    k_big, w = check_reweight(LARGE_N, dev, iters=50)
    r_big = check_resample(LARGE_N, w, dev, iters=50)
    c_big = check_codebook16(LARGE_N, w, iters=50)
    k_fleet, w = check_reweight(FLEET_N, dev, iters=50, batch=FLEET_B)
    r_fleet = check_resample(FLEET_N, w, dev, iters=50)
    c_fleet = check_codebook16(FLEET_N, w, iters=50)
    del w
    p_fleet = check_pool_take(FLEET_B, 512, FLEET_N, dev, iters=200)
    p_big = check_pool_take(None, 4096, LARGE_N, dev, iters=50)
    p_mega = check_pool_take(None, 512, 4096, dev, iters=200)
    r_mega = check_resample(MEGA_N, resample_inputs(MEGA_N, dev), dev, iters=20)
    w_big = check_winlut(dev, iters=50)
    f_mega = check_fused_step(MEGA_N, dev, iters=20)
    f_ragged = check_fused_step(MEGA_N - 1000, dev, iters=5)
    s_node = check_sphere_trace(dev, iters=100, long_range=False)
    s_long = check_sphere_trace(dev, iters=100, long_range=True)
    l_fleet = check_beam_lut(dev, iters=50)
    c_node = check_raycast(dev, iters=100, lut_build=False)
    c_build = check_raycast(dev, iters=10, lut_build=True)
    checked = (k_main, r_main, k_big, r_big, c_big, k_fleet, r_fleet, c_fleet, p_fleet, p_big,
               p_mega, r_mega, w_big, f_mega, f_ragged, s_node, s_long, l_fleet, c_node, c_build)
    ms = lambda v: "not measured" if v is None else f"{v:.5f} ms"  # noqa: E731
    for k in checked:
        lib = "" if k["library_ms"] is None else (
            f", library {ms(k['library_ms'])} (device {ms(k['library_device_ms'])})")
        print(f"kernel {k['name']} {k['shape']}: {ms(k['ms'])} (device {ms(k['device_ms'])};"
              f" plain {ms(k['plain_ms'])}, device {ms(k['plain_device_ms'])};"
              f" bound {ms(k['bound_ms'])} by {k['bound_by']}{lib}),"
              f" max abs err {k['max_abs_err']}")
    print("all-shape kernels: " + json.dumps({"kernels": checked}))

    # 4. the node at nav2 defaults (slice 1's main path)
    node_counts, node = run_node(dev)
    print("node: " + json.dumps(node) + " launches " + json.dumps(node_counts))

    # 5. the large single filter, with its pooled recovery
    large_counts, large = run_large_filter(dev)
    print("large filter: " + json.dumps(large) + " launches " + json.dumps(large_counts))

    # 6. the fleet (slice 2's main path)
    fleet_counts, fleet = run_fleet(dev)
    print("fleet: " + json.dumps(fleet) + " launches " + json.dumps(fleet_counts))

    # 7. the mega filter (slice 3's headline path)
    mega_counts, mega = run_mega(dev)
    print("mega: " + json.dumps(mega) + " launches " + json.dumps(mega_counts))

    # 8. the windowed filter (slice 3's gated path)
    win_counts, windowed = run_windowed(dev)
    print("windowed: " + json.dumps(windowed) + " launches " + json.dumps(win_counts))

    # 9. the beam node in each of its four modes (slice 4)
    beam_counts = {}
    for mode in workloads.BEAM_MODES:
        beam_counts[mode], beam = run_beam_node(dev, mode)
        print(f"beam node {mode}: " + json.dumps(beam) + " launches "
              + json.dumps(beam_counts[mode]))

    # 10. the long-range sphere-trace filter
    long_counts, long_range = run_long_range(dev)
    print("long range: " + json.dumps(long_range) + " launches " + json.dumps(long_counts))

    # 11. the windowed beam fleet (slice 4's fleet path)
    bfleet_counts, bfleet = run_beam_fleet(dev)
    print("beam fleet: " + json.dumps(bfleet) + " launches " + json.dumps(bfleet_counts))

    # each kernel at the shapes and with the launches of the newest main
    # path that runs it: B1 the windowed filter's (tail and fallback), B2
    # and B3 the mega filter's where its selective resampling fired, else
    # the windowed filter's, B4 the fleet's, B5 the mega filter's, B6 the
    # windowed filter's, B7 and R1 the beam fleet's (R1 in its LUT build),
    # B8 the long-range filter's
    by_path = {"node": node_counts, "large": large_counts, "fleet": fleet_counts,
               "mega": mega_counts, "windowed": win_counts,
               **{f"beam_node_{m}": c for m, c in beam_counts.items()},
               "long_range": long_counts, "beam_fleet": bfleet_counts}
    resampled = mega_counts["B2 resample_take"] > 0
    kernels = []
    for k, path in ((k_big, "windowed"), (r_mega if resampled else r_big,
                                          "mega" if resampled else "windowed"),
                    (p_mega if mega_counts["B3 pool_take"] else p_big,
                     "mega" if mega_counts["B3 pool_take"] else "windowed"),
                    (c_fleet, "fleet"), (f_mega, "mega"), (w_big, "windowed"),
                    (l_fleet, "beam_fleet"), (s_long, "long_range"), (c_build, "beam_fleet")):
        entry = {key: k[key] for key in ("name", "route", "source", "replaces")}
        entry["launches"] = by_path[path][k["name"]]
        entry.update({key: k[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms", "plain_device_ms", "library_device_ms", "shape")})
        entry["path"] = path
        entry["launches_by_path"] = {p: c[k["name"]] for p, c in by_path.items()}
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
