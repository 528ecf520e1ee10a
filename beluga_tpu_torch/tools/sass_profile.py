"""Static profile of the port's CUDA kernels, for a card without ``ncu``.

    python -m beluga_tpu_torch.tools.sass_profile [NAME ...] [--csrc DIR]

Builds ``csrc/<NAME>.cu`` (every source by default; ``--csrc`` another
checkout's sources) with the flags of ``ops/_build.py`` into a temporary
directory, and prints one JSON object per ``__global__`` function: ptxas's
registers, shared memory and spills, the SASS instruction count by class
(``cuobjdump -sass``), the instructions of each loop body (a backward
branch and its target) and of each subroutine that the kernel calls (the
slow paths of IEEE division and ``fmodf``).  Needs ``nvcc`` and
``cuobjdump``; counts are static: a loop body's count is what one pass of it
issues when no branch inside it is taken.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from beluga_tpu_torch.ops import _build

_FUNCTION = re.compile(r"Function : (\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*?);")
_TARGET = re.compile(r"0x([0-9a-f]+)")
_PTXAS = re.compile(r"Compiling entry function '(\S+)'|Used (\d+) registers(?:.*?(\d+) bytes smem)?"
                    r"|(\d+) bytes spill stores, (\d+) bytes spill loads")

CLASSES = (
    ("mufu", ("MUFU",)),
    ("f32", ("FADD", "FMUL", "FFMA", "FSETP", "FMNMX", "FSEL", "FCHK", "FRND", "FSET")),
    ("convert", ("F2I", "I2F", "F2F", "I2FP", "F2IP")),
    ("int", ("IMAD", "IADD", "ISETP", "LOP", "SHF", "LEA", "IABS", "IMNMX", "SEL", "PRMT",
             "POPC", "FLO", "BREV", "SGXT", "ISCADD", "IMUL", "VIADD", "VIMNMX")),
    ("load_global", ("LDG",)),
    ("load_shared", ("LDS",)),
    ("store", ("STG", "STS", "ST.", "STL")),
    ("load_other", ("LDC", "LDL", "ULDC", "LD.")),
    ("branch", ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "BAR", "WARPSYNC", "BMOV", "JMP")),
    ("move", ("MOV", "S2R", "S2UR", "CS2R", "R2UR", "SHFL", "VOTE", "UMOV", "P2R", "R2P", "PLOP")),
)


def classify(op: str) -> str:
    for name, prefixes in CLASSES:
        if any(op.startswith(p) for p in prefixes):
            return name
    return "other"


def parse_sass(text: str) -> dict[str, list[tuple[int, str, str]]]:
    """``{mangled function: [(address, opcode, operands)]}``."""
    out: dict[str, list[tuple[int, str, str]]] = {}
    current = None
    for line in text.splitlines():
        m = _FUNCTION.search(line)
        if m:
            current = out.setdefault(m.group(1), [])
            continue
        m = _INSTR.search(line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(3), m.group(4)))
    return out


def profile_function(instrs: list[tuple[int, str, str]]) -> dict:
    ops = collections.Counter(op for _, op, _ in instrs if op != "NOP")
    classes = collections.Counter()
    for op, n in ops.items():
        classes[classify(op)] += n
    loops, calls = [], set()
    addr_index = {a: i for i, (a, _, _) in enumerate(instrs)}
    for i, (addr, op, rest) in enumerate(instrs):
        t = _TARGET.search(rest)
        if not t:
            continue
        target = int(t.group(1), 16)
        if op.startswith("BRA") and target < addr and target in addr_index:
            body = [o for _, o, _ in instrs[addr_index[target]:i + 1] if o != "NOP"]
            loops.append({"from": hex(target), "to": hex(addr), "instructions": len(body),
                          "mufu": sum(o.startswith("MUFU") for o in body),
                          "calls": sum(o.startswith("CALL") for o in body),
                          "by_class": dict(collections.Counter(map(classify, body))
                                           .most_common())})
        if op.startswith("CALL"):
            calls.add(target)
    # a subroutine runs from its entry to its RET
    subs = []
    for entry in sorted(calls):
        if entry not in addr_index:
            continue
        n = 0
        for _, o, _ in instrs[addr_index[entry]:]:
            n += o != "NOP"
            if o.startswith("RET"):
                break
        subs.append({"entry": hex(entry), "instructions": n})
    return {"instructions": sum(ops.values()), "by_class": dict(classes.most_common()),
            "top_opcodes": dict(ops.most_common(16)), "loops": loops, "subroutines": subs}


def ptxas_usage(log: str) -> dict[str, dict]:
    usage: dict[str, dict] = {}
    current = None
    for line in log.splitlines():
        m = _PTXAS.search(line)
        if not m:
            continue
        if m.group(1):
            current = usage.setdefault(m.group(1), {})
        elif m.group(2) and current is not None:
            current.update(registers=int(m.group(2)), smem_bytes=int(m.group(3) or 0))
        elif m.group(4) and current is not None:
            current.update(spill_stores=int(m.group(4)), spill_loads=int(m.group(5)))
    return usage


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", help="csrc/<name>.cu (default: every source)")
    ap.add_argument("--csrc", default=str(_build.CSRC), help="the sources' directory")
    args = ap.parse_args(argv)
    csrc = Path(args.csrc)
    names = args.names or sorted(p.stem for p in csrc.glob("*.cu"))
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            lib = Path(tmp) / f"lib{name}.so"
            build = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                                    str(csrc / f"{name}.cu")], capture_output=True, text=True)
            if build.returncode != 0:
                print(build.stdout + build.stderr, file=sys.stderr)
                return 1
            usage = ptxas_usage(build.stdout + build.stderr)
            sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                                  check=True).stdout
            for fn, instrs in parse_sass(sass).items():
                print(json.dumps({"source": str(csrc / f"{name}.cu"), "function": fn,
                                  **usage.get(fn, {}), **profile_function(instrs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
