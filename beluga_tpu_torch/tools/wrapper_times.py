"""Back-to-back times of the B1, B4, B3, B6 and B6-int8 wrappers on one
card, beside their library yardsticks.

    python -m beluga_tpu_torch.tools.wrapper_times [--iters 200]
    PYTHONPATH=OTHER python beluga_tpu_torch/tools/wrapper_times.py

Each wrapper is called ``iters`` times back to back on card tensors at the
shapes its main paths give it (B1 and B4: the node's 2000 particles and
the fleet's 64 x 4096, 60 beams, a 384 x 384 table, through the transform
entry and, where the checkout has it, the states entry; B3: the fleet's 64 pools of 512 rows x 4096
draws, the large filter's 4096 rows x 262144 and the mega filter's 512 x
4096; B6 and B6-int8: 262144 particles on a [64, 128, 128] table, tile
512, the miss weight and the int8 scale as 0-d card tensors, as the filters
pass them), between two CUDA events after a warm-up, so that the host's
cost of issuing a call counts wherever it exceeds the card's time for it;
beside them ``torch.gather`` (B3) and ``grid_sample`` (B6) on the same
shapes.  The inputs are random: at these sizes a call's time is the host's.
The second form times the wrappers of the checkout rooted at ``OTHER``.
Prints one JSON line; exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

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
    for lead, p, n in (((64,), 512, 4096), ((), 4096, 262144), ((), 512, 4096)):
        pool = torch.randn((*lead, p, 2), generator=gen, device=dev)
        idx = torch.randint(0, p, (*lead, n), generator=gen, device=dev, dtype=torch.int32)
        gather_idx = idx.long()[..., None].expand(*idx.shape, 2).contiguous()
        label = f"B3 [{', '.join(map(str, (*lead, p, 2)))}] x {n}"
        out[label] = per_call_ms(lambda: b3.pool_take(pool, idx), args.iters)
        out[label + " torch.gather"] = per_call_ms(lambda: torch.gather(pool, -2, gather_idx),
                                                   args.iters)
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(json.dumps({"device": smi, "ms_per_call": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
