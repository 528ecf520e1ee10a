"""Run one cell of the benchmark once and print its result line.

    python3 mclbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Cells are the ``workloads`` of ``BENCHMARK.json``.  With ``--trace 0`` the
last line of standard output carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics read from a ``torch.profiler`` trace
of a slice of the window (written under ``$TMPDIR``).  The numbers that
decide ``correct`` are the last lines of standard error, each beside its
limit, and the last key of the result line.  Exits non-zero, printing no
result, without the CUDA cards the cell asks for, or when JAX or the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import os
import sys
import time


def process_start() -> float:
    """The epoch time at which this process started (``/proc``), or now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


STARTED = process_start()


def main(argv=None) -> int:
    import argparse
    import json
    from pathlib import Path

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    # kernel and compiler caches at fixed paths inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(root / "build" / "mclbench" / sub)
    import torch

    torch.set_num_threads(1)
    from mclbench import harness

    bench, cell, _, _ = harness.cell_files(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 3
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              device="cuda", started=STARTED)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 4
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
