"""Back-to-back times of the B1, B4, B3, B6 and B6-int8 wrappers on one
card, beside their library yardsticks, and what a B3 or B6 call costs the
host.

    python -m beluga_tpu_torch.tools.wrapper_times [--iters 200]
    PYTHONPATH=OTHER python beluga_tpu_torch/tools/wrapper_times.py

Each wrapper is called ``iters`` times back to back on card tensors at the
shapes its main paths give it (B1 and B4: the node's 2000 particles and
the fleet's 64 x 4096, 60 beams, a 384 x 384 table, through the transform
entry and, where the checkout has it, the states entry; B3: the fleet's 64 pools of 512 rows x 4096
draws, the large filter's 4096 rows x 262144 and the mega filter's 512 x
4096, through the row entry and, where the checkout has it, the draw
entry; B6 and B6-int8: 262144 particles on a [64, 128, 128] table, tile
512, the miss weight and the int8 scale as 0-d card tensors, as the filters
pass them, through the coordinates entry and, where the checkout has them,
the states entry and the coverage entry), between two CUDA events after a
warm-up, so that the host's cost of issuing a call counts wherever it
exceeds the card's time for it; beside them ``torch.gather`` (B3) and
``grid_sample`` (B6) on the same shapes.  The inputs are random: at these
sizes a call's time is the host's.  ``host_us`` splits a wrapper call's
host cost on the host clock: the stream handle (``torch.cuda.current_stream``
and the raw handle the wrappers take), the checks' cache key and lookup
(``_plan``), an output's ``torch.empty``, and the ctypes call of a launcher
that returns at once (no particles).  The second form times the wrappers of
the checkout rooted at ``OTHER``.  Prints one JSON line; exits 2 without a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F


def per_call_ms(fn, iters: int) -> float:
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


def reweight_times(dev, gen, iters: int) -> dict:
    """B1 and B4 (cube mode) back to back at the node's and the fleet's
    shapes, through each entry the checkout has."""
    from beluga_tpu_torch.lie import SE2
    from beluga_tpu_torch.ops import cuda_reweight as b1

    out = {}
    codes = torch.randint(0, 256, (384, 384), generator=gen, device=dev, dtype=torch.uint8)
    book = torch.rand(256, generator=gen, device=dev)
    v3 = b1.build_values3(codes, book)
    field = SE2.identity(device=dev)
    for lead, n in (((), 2000), ((64,), 4096)):
        xy = torch.rand((*lead, n, 2), generator=gen, device=dev) * 19.2
        th = torch.rand((*lead, n), generator=gen, device=dev) * 6.28
        states = SE2.from_xytheta(xy[..., 0], xy[..., 1], th)
        tf = [t.contiguous() for t in (states.x, states.y, states.rot.cos, states.rot.sin)]
        points = torch.rand((*lead, 60, 2), generator=gen, device=dev) * 7 - 3.5
        mask = torch.rand((*lead, 60), generator=gen, device=dev) < 0.5
        rest = (points, mask, 0.05, 0.5)
        shape = "x".join(map(str, (*lead, n, 60)))
        for name, values3 in (("B1", None), ("B4", v3)):
            out[f"{name} {shape} transform entry"] = per_call_ms(
                lambda: b1.fused_reweight(codes, book, *tf, *rest, values3=values3), iters)
            if hasattr(b1, "fused_reweight_states"):
                out[f"{name} {shape} states entry"] = per_call_ms(
                    lambda: b1.fused_reweight_states(codes, book, field, states, *rest,
                                                     values3=values3), iters)
    return out


def host_us(fn, iters: int = 20000) -> float:
    """Host µs per call of ``fn`` (no card work waited for)."""
    for _ in range(100):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return 1e6 * (time.perf_counter() - t0) / iters


def host_costs(dev) -> dict:
    """The parts of a B3 or B6 wrapper call's host cost, µs a call."""
    from beluga_tpu_torch.ops import cuda_pool_take as b3
    from beluga_tpu_torch.ops import cuda_winlut as b6

    out = {"torch.cuda.current_stream(dev).cuda_stream":
           host_us(lambda: torch.cuda.current_stream(dev).cuda_stream)}
    pool = torch.zeros((64, 512, 2), device=dev)
    idx = torch.zeros((64, 4096), dtype=torch.int32, device=dev)

    def meta(t):
        return t.shape, t.dtype, t.device, t.is_contiguous()

    out["B3 row entry _plan (key and cache)"] = host_us(lambda: b3._plan(meta(pool), meta(idx)))
    out["torch.empty"] = host_us(lambda: torch.empty((64, 4096, 2), device=dev))
    fn = b3._take.bind()
    out["ctypes call, no launch"] = host_us(
        lambda: fn(pool.data_ptr(), 512, 2, idx.data_ptr(), 0, 64, pool.data_ptr(), 0))
    if hasattr(b3, "pooled_free_cells"):
        from beluga_tpu_torch.ops._build import stream_ptr

        out["raw stream handle (stream_ptr)"] = host_us(lambda: stream_ptr(dev))
        cand = torch.zeros((64, 512), dtype=torch.int64, device=dev)
        theta = torch.zeros((64, 4096), device=dev)
        out["B3 draw entry _plan (key and cache)"] = host_us(
            lambda: b3._draw_plan(meta(pool[0]), meta(cand), meta(idx), meta(theta)))
    if hasattr(b6, "winlut_lookup_states"):
        from beluga_tpu_torch.lie import SE2

        st = SE2.identity((262144,), device=dev)
        field = SE2.identity(device=dev)
        x0 = torch.zeros((), dtype=torch.int64, device=dev)
        th0 = torch.zeros((), device=dev)
        scalars = (("lut.x0", meta(x0), torch.int64), ("lut.y0", meta(x0), torch.int64),
                   ("lut.theta0", meta(th0), torch.float32))
        out["B6 states entry _plan (key and cache)"] = host_us(
            lambda: b6._states_plan((meta(st.xy), meta(st.rot.z)),
                                    (meta(field.xy), meta(field.rot.z)), scalars, 512, 16))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wrapper_times: no CUDA device", file=sys.stderr)
        return 2
    from beluga_tpu_torch.ops import cuda_pool_take as b3
    from beluga_tpu_torch.ops import cuda_winlut as b6

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    out.update(reweight_times(dev, gen, args.iters))
    free = torch.randn((147456, 2), generator=gen, device=dev)
    for lead, p, n in (((64,), 512, 4096), ((), 4096, 262144), ((), 512, 4096)):
        pool = torch.randn((*lead, p, 2), generator=gen, device=dev)
        idx = torch.randint(0, p, (*lead, n), generator=gen, device=dev, dtype=torch.int32)
        gather_idx = idx.long()[..., None].expand(*idx.shape, 2).contiguous()
        label = f"B3 [{', '.join(map(str, (*lead, p, 2)))}] x {n}"
        out[label] = per_call_ms(lambda: b3.pool_take(pool, idx), args.iters)
        out[label + " torch.gather"] = per_call_ms(lambda: torch.gather(pool, -2, gather_idx),
                                                   args.iters)
        if hasattr(b3, "pooled_free_cells"):
            cand = torch.randint(0, free.shape[0], (*lead, p), generator=gen, device=dev)
            theta = torch.rand((*lead, n), generator=gen, device=dev)
            out[label + " draw entry"] = per_call_ms(
                lambda: b3.pooled_free_cells(free, cand, idx, theta), args.iters)
    n, k, wx, wy, tile, tblk = 262144, 64, 128, 128, 512, 16
    xi = torch.rand(n, generator=gen, device=dev) * (wx - 1)
    yi = torch.rand(n, generator=gen, device=dev) * (wy - 1)
    t = torch.sort(torch.rand(n, generator=gen, device=dev) * (k - 1)).values
    miss = torch.tensor(0.5, device=dev)
    scale = torch.tensor(0.01, device=dev)
    tables = {"B6": torch.rand((k, wx, wy), generator=gen, device=dev).to(torch.bfloat16),
              "B6-int8": torch.randint(-127, 128, (k, wx, wy), generator=gen, device=dev,
                                       dtype=torch.int8)}
    grid = torch.stack([2 * yi / (wy - 1) - 1, 2 * xi / (wx - 1) - 1, 2 * t / (k - 1) - 1],
                       -1)[None, None, None].contiguous()
    for name, table in tables.items():
        s = scale if table.dtype == torch.int8 else None
        label = f"{name} {n} x [{k}, {wx}, {wy}] {str(table.dtype).split('.')[-1]}"
        out[label] = per_call_ms(
            lambda: b6.winlut_lookup(table, xi, yi, t, miss, 1.0, tile, tblk, scale=s),
            args.iters)
        vol = (table.float() * (scale if s is not None else 1.0))[None, None].contiguous()
        out[label + " grid_sample"] = per_call_ms(
            lambda: F.grid_sample(vol, grid, mode="bilinear", align_corners=True), args.iters)
        if hasattr(b6, "winlut_lookup_states"):
            states, lut, geo, centre = states_case(dev, gen, n, table, s)
            out[label + " states entry"] = per_call_ms(
                lambda: b6.winlut_lookup_states(lut, states, miss, 1.0, tile, tblk), args.iters)
            if s is None:
                out[f"B6 coverage {n}"] = per_call_ms(
                    lambda: b6.winlut_coverage_states(geo, states, *centre, tile, tblk),
                    args.iters)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(json.dumps({"device": smi, "ms_per_call": out, "host_us": host_costs(dev)}))
    return 0


def states_case(dev, gen, n: int, table, scale):
    """States about a window of ``table`` on the 384 x 384 arena at 5 cm
    (the windowed filter's geometry), the window's LUT record, its
    geometry and its centre, for B6's states and coverage entries."""
    import math

    from beluga_tpu_torch.lie import SE2
    from beluga_tpu_torch.models.sensor.likelihood_field_winlut import WindowedScanLut
    from beluga_tpu_torch.ops.cuda_winlut import WindowGeometry

    k, wx, wy = table.shape
    dth = 2.0 * math.pi / 128.0
    xy = torch.rand((n, 2), generator=gen, device=dev) * 3.0 + 8.0
    th = torch.sort(torch.rand(n, generator=gen, device=dev) * 0.6).values
    states = SE2.from_xytheta(xy[:, 0], xy[:, 1], th)
    field = SE2.identity(device=dev)
    pad = 82
    centre = (torch.tensor(9.5, device=dev), torch.tensor(9.5, device=dev),
              torch.tensor(0.3, device=dev))
    geo = WindowGeometry(world_to_field=field, resolution=0.05, pad=pad, hp=384 + 2 * pad,
                         wp=384 + 2 * pad, k_bins=k, win_x=wx, win_y=wy, dth=dth)
    x0, y0, theta0 = (torch.tensor(v, device=dev) for v in (190 + pad - 64, 190 + pad - 64, 0.0))
    lut = WindowedScanLut(values_t=table, x0=x0, y0=y0, theta0=theta0.float(),
                          miss=torch.tensor(0.5, device=dev), resolution=0.05,
                          world_to_field=field, pad_cells=pad, k_bins=k, win_x=wx, win_y=wy,
                          dth=dth, scale=scale)
    return states, lut, geo, centre


if __name__ == "__main__":
    sys.exit(main())
