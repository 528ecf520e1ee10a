"""A/B of kernel designs on one card: ``profile_update`` over package
variants, run in turns.

    python -m beluga_tpu_torch.tools.ab_variants [--variants NAME,...]
        [--parent DIR] [--workloads mega,large] [--scans 16] [--out FILE]

Each variant is a copy of this package under ``build/variants/<name>/``
with the named source edits of :data:`VARIANTS` applied (each edit must
match its source exactly once), so that one design element is taken out
of a kernel at a time (leave-one-out); ``current`` is this package as it
is, and ``--parent DIR`` adds another checkout (its root holds
``beluga_tpu_torch/``) as ``parent``.  Each variant builds its kernels into
its own ``build/``.  The variants' ``tools/profile_update.py`` run in
turns, in the order given and then reversed (A B C, C B A), each in a
process of its own with the variant first on the path; every line they
print is kept (``--out``, JSON lines tagged with the variant and the
turn), and one line per run and workload gives the wall and busy ms per
update, the kernel launches per update and each hand-written kernel's
device ms per update.  Every variant runs this checkout's
``tools/profile_update.py`` with its own package first on the path, so
that a parent tree is profiled on the workloads defined here.  Variants
named ``*_probe_*`` are not designs but probes: they drop or cheapen one
part of a kernel to show what it costs.  With ``--checks``, each turn
runs ``chip_smoke.py``'s named kernel checks (:data:`CHECKS`) on the
variant's package instead of the profile, one JSON line per check and
shape: its time back to back and its device time a call, and those of
the model-level call it serves with its launches.  A run without
a CUDA device exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parents[1]
ROOT = PACKAGE.parent
VARIANT_DIR = ROOT / "build" / "variants"

# name -> [(file under the package, text, replacement)]
VARIANTS: dict[str, list[tuple[str, str, str]]] = {
    # B5: the heading bin through the log-likelihood slot and x', y' read
    # back after the slab minimum, as the first port of B5 did (L2 loads the compiler
    # cannot forward from the stores)
    "b5_two_pass": [
        ("csrc/winlut.cu",
         "      window_xy(sc, m.x, m.y, &xf[j], &yf[j]);\n      tf[j] = m.t;\n",
         "      if (s < tile && i < static_cast<size_t>(n)) lw[i] = m.t;\n"),
        ("csrc/winlut.cu",
         "        const float w = trilinear<kSharedTable>(table, wx, wy, tblk, t_lo, xf[j], yf[j],"
         " tf[j],\n",
         "        window_xy(sc, __ldcg(xo + i), __ldcg(yo + i), &xf[j], &yf[j]);\n"
         "        const float w = trilinear<kSharedTable>(table, wx, wy, tblk, t_lo, xf[j], yf[j],"
         " __ldcg(lw + i),\n"),
    ],
    # B5: every table read through L2, none staged in shared memory
    "b5_l2_table": [
        ("csrc/winlut.cu",
         "  const bool shared = static_cast<size_t>(k) * wx * wy * 2 <= kMaxTableSmem;\n",
         "  const bool shared = false;\n"),
    ],
    # B5: the table copied through registers before the first tile's motion
    # sample can use them, not by cp.async beside it
    "b5_sync_table_copy": [
        ("csrc/winlut.cu",
         "      asm volatile(\"cp.async.cg.shared.global [%0], [%1], 16;\\n\" ::\"r\"(to), "
         "\"l\"(vals + 8 * v));\n",
         "      reinterpret_cast<uint4*>(dst)[v] = "
         "__ldg(reinterpret_cast<const uint4*>(vals) + v);\n"),
    ],
    # B5: each slot's inputs of the next tile loaded as soon as its motion
    # sample has used the registers, not after the slab minimum
    "b5_prefetch_per_slot": [
        ("csrc/winlut.cu",
         "    if (next < tiles) {  // in flight during the lookups\n#pragma unroll\n"
         "      for (int j = 0; j < kSlots; ++j) load_slot<kSlots>(x, y, th, z, n, tile, next, j, "
         "in);\n    }\n",
         ""),
        ("csrc/winlut.cu",
         "      const Moved m = propagate(sc, in[0][j], in[1][j], in[2][j], in[3][j], in[4][j], "
         "in[5][j]);\n",
         "      const Moved m = propagate(sc, in[0][j], in[1][j], in[2][j], in[3][j], in[4][j], "
         "in[5][j]);\n"
         "      if (next < tiles) load_slot<kSlots>(x, y, th, z, n, tile, next, j, in);\n"),
    ],
    # B5: each tile's inputs loaded at the top of its iteration, none in
    # flight across tiles
    "b5_no_prefetch": [
        ("csrc/winlut.cu",
         "    if (next < tiles) {  // in flight during the lookups\n#pragma unroll\n"
         "      for (int j = 0; j < kSlots; ++j) load_slot<kSlots>(x, y, th, z, n, tile, next, j, "
         "in);\n    }\n",
         ""),
        ("csrc/winlut.cu",
         "#pragma unroll\n"
         "  for (int j = 0; j < kSlots; ++j) "
         "load_slot<kSlots>(x, y, th, z, n, tile, tile_id, j, in);\n",
         ""),
        ("csrc/winlut.cu",
         "    float xf[kSlots], yf[kSlots], tf[kSlots];\n",
         "#pragma unroll\n"
         "    for (int j = 0; j < kSlots; ++j) "
         "load_slot<kSlots>(x, y, th, z, n, tile, tile_id, j, in);\n"
         "    float xf[kSlots], yf[kSlots], tf[kSlots];\n"),
    ],
    # B5: sin and cos of each heading by sinf and cosf, not one sincosf
    "b5_sin_cos": [
        ("csrc/winlut.cu",
         "  float s1, c1;\n  sincosf(th1, &s1, &c1);\n"
         "  m.x = __fadd_rn(x, __fmul_rn(trans, c1));\n"
         "  m.y = __fadd_rn(y, __fmul_rn(trans, s1));\n"
         "  sincosf(th2, &m.s, &m.c);\n",
         "  m.x = __fadd_rn(x, __fmul_rn(trans, cosf(th1)));\n"
         "  m.y = __fadd_rn(y, __fmul_rn(trans, sinf(th1)));\n"
         "  m.c = cosf(th2);\n  m.s = sinf(th2);\n"),
    ],
    # probe: B5 with the hardware's approximate sin and cos (wrong results)
    "b5_probe_fast_trig": [
        ("csrc/winlut.cu",
         "  float s1, c1;\n  sincosf(th1, &s1, &c1);\n"
         "  m.x = __fadd_rn(x, __fmul_rn(trans, c1));\n"
         "  m.y = __fadd_rn(y, __fmul_rn(trans, s1));\n"
         "  sincosf(th2, &m.s, &m.c);\n",
         "  m.x = __fadd_rn(x, __fmul_rn(trans, __cosf(th1)));\n"
         "  m.y = __fadd_rn(y, __fmul_rn(trans, __sinf(th1)));\n"
         "  m.c = __cosf(th2);\n  m.s = __sinf(th2);\n"),
    ],
    # probe: B5 without its table lookups (wrong results)
    "b5_probe_no_lookup": [
        ("csrc/winlut.cu",
         "        const float w = trilinear<kSharedTable>(table, wx, wy, tblk, t_lo, xf[j], yf[j],"
         " tf[j],\n                                                sc[kMiss], sc[kBase]);\n",
         "        const float w = __fadd_rn(xf[j], __fadd_rn(yf[j], __fadd_rn(tf[j], t_lo)));\n"),
    ],
    # B2: the search within the bracket through L2, nothing staged
    "b2_no_window": [
        ("csrc/resample.cu",
         "  const bool staged = len <= kWindow;\n",
         "  const bool staged = false;\n"),
    ],
    # B1/B4: the models compose world_to_field @ states in PyTorch (15
    # elementwise kernels and 4 copies) and call the transform entry
    "reweight_transform_outside": [
        ("models/sensor/likelihood_field.py",
         "    from beluga_tpu_torch.ops.cuda_reweight import fused_reweight_states\n\n"
         "    codes, book = codes_book\n"
         "    states = SE2(states.xy.contiguous(), SO2(states.rot.z.contiguous()))\n"
         "    return fused_reweight_states(codes, book, field.world_to_field, states, points, "
         "beam_mask,\n",
         "    from beluga_tpu_torch.ops.cuda_reweight import fused_reweight\n\n"
         "    codes, book = codes_book\n"
         "    tf = field.world_to_field @ states\n"
         "    return fused_reweight(codes, book, tf.x.contiguous(), tf.y.contiguous(),\n"
         "                          tf.rot.cos.contiguous(), tf.rot.sin.contiguous(), points, "
         "beam_mask,\n"),
    ],
    # B1/B4: one lane a particle (a thread per particle, the first form)
    "reweight_one_lane": [
        ("csrc/reweight.cu",
         "  a.lanes_log2 = lanes_log2_for(static_cast<long long>(n) * batch, nb);\n",
         "  a.lanes_log2 = 0;\n"),
    ],
    # B1/B4: every beam in shared memory and a mask branch in the beam loop
    "reweight_mask_branch": [
        ("csrc/reweight.cu",
         "    const bool on = b < nb && mask[b];\n",
         "    const bool on = b < nb;\n"),
        ("csrc/reweight.cu",
         "      const float2 pt = s_beam[j];\n",
         "      if (!a.beam_mask[f * a.nb + j]) continue;\n"
         "      const float2 pt = s_beam[j];\n"),
    ],
    # B1: the codebook's raw values in shared memory, the cube or logf on
    # every beam
    "reweight_decode_in_loop": [
        ("csrc/reweight.cu",
         "      s_val[j] = decode<kLog>(j < a.k ? a.codebook[j] : 0.0f);\n",
         "      s_val[j] = j < a.k ? a.codebook[j] : 0.0f;\n"),
        ("csrc/reweight.cu",
         "          v = s_val[__ldg(static_cast<const uint8_t*>(a.table) + cell)];\n",
         "          v = decode<kLog>(s_val[__ldg(static_cast<const uint8_t*>(a.table) + cell)]);\n"),
    ],
    # B1/B4: the IEEE divisions on every endpoint
    "reweight_divide": [
        ("csrc/reweight.cu",
         "  if (fabsf(__fsub_rn(qx, rintf(qx))) > tol && fabsf(__fsub_rn(qy, rintf(qy))) > tol) {\n",
         "  if (false) {\n"),
    ],
    # probe: B1 and B4 without their table gather (wrong results): the
    # decoded value of the cell index's low byte, or the index's bits
    "reweight_probe_no_gather": [
        ("csrc/reweight.cu",
         "          v = s_val[__ldg(static_cast<const uint8_t*>(a.table) + cell)];\n",
         "          v = s_val[cell & (kCodes - 1)];\n"),
        ("csrc/reweight.cu",
         "          v = __uint_as_float(\n"
         "              static_cast<uint32_t>(__ldg(static_cast<const uint16_t*>(a.table) + cell)) "
         "<< 16);\n",
         "          v = __int_as_float(cell & 0x3fff0000);\n"),
    ],
    # R1: the bit plane through L1/L2 in both entries, never staged in
    # shared memory
    "r1_plane_l2": [
        ("csrc/raycast.cu", "  const bool shared = plane_bytes(h, wpr) <= kMaxSmem;\n",
         "  const bool shared = false;\n"),
        ("csrc/raycast.cu", "  if (plane + rest <= kMaxSmem) {\n", "  if (false) {\n"),
    ],
    # R1: the uint8 free mask through L1/L2, a byte a cell (the first form's
    # read), in both entries
    "r1_bytes_l2": [
        ("csrc/raycast.cu", "  const bool shared = plane_bytes(h, wpr) <= kMaxSmem;\n",
         "  const bool shared = false;\n"),
        ("csrc/raycast.cu", "  if (plane + rest <= kMaxSmem) {\n", "  if (false) {\n"),
        ("csrc/raycast.cu",
         "    const int i = y * pl.wpr + (x >> 5);\n"
         "    word = kShared ? pl.bits[i] : __ldg(pl.bits + i);\n"
         "  }\n  return __funnelshift_r(word, word, x) & 1u;  // bit x & 31\n",
         "    word = __ldg(reinterpret_cast<const uint8_t*>(pl.bits) + y * pl.wpr + x);\n"
         "  }\n  return word != 0;\n"),
        ("ops/raycast.py",
         "        plane = FreePlane(pack_free_bits(grid.free_mask).contiguous(), world)\n",
         "        plane = FreePlane(grid.free_mask.to(torch.uint8).contiguous(), world)\n"),
    ],
    # R1: a branchy step, as the first form: four signed compares for the
    # inside test and a branch for each stop and each Bresenham move
    "r1_branchy_step": [
        ("csrc/raycast.cu",
         "  const bool in = (static_cast<unsigned>(x) < static_cast<unsigned>(pl.w)) &\n"
         "                  (static_cast<unsigned>(y) < static_cast<unsigned>(pl.h));\n",
         "  const bool in = x >= 0 && x < pl.w && y >= 0 && y < pl.h;\n"),
        ("csrc/raycast.cu",
         "    const bool stop = !fr | (--left == 0);\n"
         "    *hit = in & !fr;\n"
         "    const int e2 = 2 * err;\n"
         "    const bool step_x = e2 > -dy, step_y = e2 < dx;\n"
         "    if (!stop) {\n"
         "      err += (step_y ? dx : 0) - (step_x ? dy : 0);\n"
         "      x += step_x ? sx : 0;\n"
         "      y += step_y ? sy : 0;\n"
         "    }\n"
         "    return stop;\n",
         "    if (!in) {\n      *hit = false;\n      return true;\n    }\n"
         "    if (!fr) {\n      *hit = true;\n      return true;\n    }\n"
         "    if (--left == 0) {\n      *hit = false;\n      return true;\n    }\n"
         "    const int e2 = 2 * err;\n"
         "    if (e2 > -dy) {\n      err -= dy;\n      x += sx;\n    }\n"
         "    if (e2 < dx) {\n      err += dx;\n      y += sy;\n    }\n"
         "    return false;\n"),
    ],
    # R1: the standard line's steps not pinned in registers (nvcc then
    # rebuilds sy from the far cell at every step)
    "r1_no_step_pin": [
        ("csrc/raycast.cu", '    asm("" : "+r"(sx), "+r"(sy));\n', ""),
    ],
    # R1: no occupancy bound, the registers the compiler wants (the first
    # build's 46-49 a thread in the ray entry: two blocks of 512 an SM)
    "r1_no_min_blocks": [
        ("csrc/raycast.cu", "constexpr int kCastMinBlocks = 4;",
         "constexpr int kCastMinBlocks = 1;"),
        ("csrc/raycast.cu", "constexpr int kExactMinBlocks = 4;",
         "constexpr int kExactMinBlocks = 1;"),
    ],
    # B3: the sampler's parent path: the pool by PyTorch indexing, the row
    # entry, SO2.exp (cos, sin, stack)
    "b3_draw_outside": [
        ("core/random.py",
         "    from beluga_tpu_torch.ops.cuda_pool_take import pooled_free_cells\n\n"
         "    return pooled_free_cells(free_xy, cand, idx, theta)\n",
         "    from beluga_tpu_torch.ops.cuda_pool_take import pool_take\n\n"
         "    return SE2(pool_take(free_xy[cand], idx), SO2.exp(theta))\n"),
    ],
    # B6: the lookup's window coordinates by PyTorch (the parent's chain of
    # launches) and the coordinates entry
    "b6_coords_outside": [
        ("models/sensor/likelihood_field_winlut.py",
         "    return winlut_lookup_states(lut, states, lut.miss, base=1.0, tile=tile, tblk=tblk)\n",
         "    from beluga_tpu_torch.ops.cuda_winlut import winlut_lookup\n\n"
         "    xi, yi, t = windowed_coords(lut, states)\n"
         "    return winlut_lookup(lut.values_t, xi.contiguous(), yi.contiguous(), "
         "t.contiguous(),\n"
         "                         lut.miss, base=1.0, tile=tile, tblk=tblk, scale=lut.scale)\n"),
    ],
    # B6: the windowed gate by PyTorch (the window origin, the coordinates
    # and the tiled share: the parent's ~120 launches)
    "b6_gate_outside": [
        ("models/sensor/likelihood_field_winlut.py",
         "    return winlut_coverage_states(geo, states, center_x, center_y, center_theta, "
         "tile, tblk)\n",
         "    from beluga_tpu_torch.ops.cuda_winlut import winlut_coverage_states_reference\n\n"
         "    return winlut_coverage_states_reference(geo, states, center_x, center_y, "
         "center_theta,\n"
         "                                            tile, tblk)\n"),
    ],
    # B6's states entry: each slot's state read again and its coordinates
    # computed again after the slab minimum, not kept in registers
    "b6_coords_twice": [
        ("csrc/winlut.cu",
         "      a.out[i] = trilinear(a.vals, a.wx, a.wy, a.tblk, t_lo, xf[j], yf[j], tf[j], miss, "
         "a.base,\n",
         "      window_coords(w, load_pair(a.in.xy, i, a.in.paired), "
         "load_pair(a.in.rot, i, a.in.paired), &xf[j], &yf[j], &tf[j]);\n"
         "      a.out[i] = trilinear(a.vals, a.wx, a.wy, a.tblk, t_lo, xf[j], yf[j], tf[j], miss, "
         "a.base,\n"),
    ],
    **{f"reweight_lanes_{1 << g}": [
        ("csrc/reweight.cu",
         "  a.lanes_log2 = lanes_log2_for(static_cast<long long>(n) * batch, nb);\n",
         f"  a.lanes_log2 = {g};\n"),
    ] for g in (1, 2, 3, 4)},
}


# --checks: chip_smoke.py's kernel checks by name, as calls on ``cs`` (the
# module) and ``dev``
CHECKS = {
    "pool_draw": ["cs.check_pool_draw(64, 512, 4096, dev, 200)",
                  "cs.check_pool_draw(None, 4096, 262144, dev, 50)",
                  "cs.check_pool_draw(None, 512, 4096, dev, 200)"],
    "pool_take": ["cs.check_pool_take(64, 512, 4096, dev, 200)",
                  "cs.check_pool_take(None, 4096, 262144, dev, 50)"],
    "winlut_states": ["cs.check_winlut_states(dev, 50)",
                      "cs.check_winlut_states(dev, 50, table_dtype='int8')"],
    "winlut_coverage": ["cs.check_winlut_coverage(dev, 50)"],
    "winlut": ["cs.check_winlut(dev, 50)", "cs.check_winlut_int8(dev, 50)"],
}


def run_checks(root: Path, checks: str) -> list[dict]:
    """``chip_smoke.py``'s checks of ``checks`` on the package under
    ``root``, in a process of its own; one record per check."""
    calls = [c for name in checks.split(",") for c in CHECKS[name]]
    code = "\n".join([
        "import json, sys",
        f"sys.path[:0] = [{str(root)!r}, {str(ROOT)!r}]",
        "import torch",
        "import chip_smoke as cs",
        "dev = torch.device('cuda')",
        f"for call in {calls!r}:",
        "    r = eval(call)",
        "    print(json.dumps({'check': call, **{k: r.get(k) for k in ('name', 'shape', 'ms',"
        " 'device_ms', 'plain_ms', 'bound_ms', 'model_ms', 'model_device_ms',"
        " 'model_launches', 'model_copies')}}))",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def make_variant(name: str) -> Path:
    """``build/variants/<name>/``: a copy of the package with the edits of
    ``VARIANTS[name]``; returns the copy's root."""
    root = VARIANT_DIR / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PACKAGE, root / PACKAGE.name,
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    for rel, text, replacement in VARIANTS[name]:
        path = root / PACKAGE.name / rel
        source = path.read_text()
        if source.count(text) != 1:
            raise ValueError(f"variant {name}: the edit of {rel} matches "
                             f"{source.count(text)} times, not once")
        path.write_text(source.replace(text, replacement))
    return root


def build_kernels(root: Path) -> None:
    """Every kernel of the package under ``root``, built before the turns
    (one nvcc a source, started together), so that no turn times a build."""
    subprocess.run([sys.executable, "-c",
                    "from beluga_tpu_torch.ops import _build; _build.build_all()"],
                   env=dict(os.environ, PYTHONPATH=str(root)), check=True)


def run_profile(root: Path, workloads: str, scans: int) -> list[dict]:
    """This checkout's ``tools/profile_update.py`` on the package under
    ``root``, in a process of its own; its JSON lines."""
    env = dict(os.environ, PYTHONPATH=str(root))
    out = subprocess.run(
        [sys.executable, str(PACKAGE / "tools" / "profile_update.py"),
         "--scans", str(scans), "--workloads", workloads],
        env=env, capture_output=True, text=True, check=True,
    ).stdout
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="current",
                    help="comma-separated, in turn order: current, parent or any of "
                         + ",".join(VARIANTS))
    ap.add_argument("--parent", default=None, help="a parent checkout's root")
    ap.add_argument("--workloads", default="mega")
    ap.add_argument("--scans", type=int, default=16)
    ap.add_argument("--out", default=None, help="write every profile line here")
    ap.add_argument("--checks", default=None,
                    help="run these chip_smoke checks instead of the profile: "
                         + ",".join(CHECKS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_variants: no CUDA device", file=sys.stderr)
        return 2
    names = args.variants.split(",")
    roots = {}
    for name in names:
        if name == "current":
            roots[name] = ROOT
        elif name == "parent":
            if not args.parent:
                raise SystemExit("the parent variant needs --parent")
            roots[name] = Path(args.parent).resolve()
        else:
            roots[name] = make_variant(name)
    for root in dict.fromkeys(roots.values()):
        build_kernels(root)
    records = []
    for turn, name in enumerate(names + names[::-1]):
        if args.checks:
            for line in run_checks(roots[name], args.checks):
                records.append({"variant": name, "turn": turn, **line})
                print(json.dumps({"variant": name, "turn": turn, **line}))
            continue
        for line in run_profile(roots[name], args.workloads, args.scans):
            records.append({"variant": name, "turn": turn, **line})
            print(json.dumps({"variant": name, "turn": turn, "workload": line["workload"],
                              "wall": line["wall_ms_per_update"],
                              "busy": line["device_busy_ms_per_update"],
                              "launches": line["kernel_launches_per_update"],
                              "kernels": {k: v["device_ms"] for k, v in
                                          line["hand_kernels_per_update"].items()}}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
