"""The readings that the limits of ``correct`` are set from: one cell run
on many seeds in one process, each run's numbers beside the control's (the
reference in the nearest lower precision put in the program's place).

    python3 mclbench/readings.py --workload <cell> --seeds 1,2,3 --seconds 3 [--out FILE]

Prints one JSON line a seed: ``checks`` (the program's numbers),
``control`` (the control's), ``correct``, ``failed`` and the end-to-end
metrics of the short window; with ``--out`` it appends the same lines to
that file.  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch

    torch.set_num_threads(1)
    from mclbench import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        r = harness.run_cell(args.workload, seed, args.seconds, False, device="cuda",
                             started=t0, control=True, log=lambda line: None)
        line = json.dumps({
            "workload": args.workload, "seed": seed, "correct": r["correct"],
            "failed": r["failed"], "attempted": r["attempted"],
            "checks": {k: v["value"] for k, v in r["checks"].items()},
            "control": {k: v["value"] for k, v in r["control_checks"].items()},
            "metrics": {k: v["value"] for k, v in r["metrics"].items()},
            "seconds": time.time() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
