"""The harness's layout: nothing of JAX or the JAX package is imported,
and a configuration, a traffic mix and a per-layer metric are added by
adding files and entries alone."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from mclbench import harness

ROOT = Path(__file__).resolve().parents[2]
BANNED = {"jax", "jaxlib", "flax", "beluga_tpu", "benchmarks"}


def _imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((ROOT / "mclbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imported(path) & BANNED  # whole top-level names: beluga_tpu_torch is allowed


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); from mclbench import harness; "
            "r = harness.run_cell('lf_fleet.track', 9, 0.1, False, device='cpu', robots=2, "
            "particles=32, log=lambda l: None); "
            "print(harness.forbidden_modules(), r['correct'])" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True).stdout.split()
    assert out == ["[]", "True"]


def test_cells_metrics_and_files_are_found_by_name():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert (ROOT / "mclbench/drivers" / f"{cfg['driver']}.py").exists()
        assert (ROOT / "mclbench/reference" / f"{cfg['reference']}.py").exists()
        assert (ROOT / "mclbench/sensors" / f"{cfg['sensor']}.py").exists()
        assert set(c["reduced"]) <= set(cfg["published"])
    for w in bench["workloads"]:
        assert (ROOT / "mclbench/traffic" / f"{w['traffic']}.json").exists()
    for m in bench["per_layer"]:
        assert (ROOT / "mclbench/metrics" / (m["name"].replace(".", "_") + ".py")).exists()
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_a_new_cell_needs_only_new_files_and_entries(tmp_path):
    """In a copy: a configuration (the field at another sigma_hit, on a
    sensor module of its own), a mix and a metric, each a new file and a
    new entry; the copy's harness runs the new cell and reports the new
    metric and the step's share of the peak from the new sensor's counts."""
    shutil.copytree(ROOT / "mclbench", tmp_path / "mclbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "mclbench/configs/lf_fleet.json").read_text())
    cfg["name"] = "lf_wide"
    cfg["likelihood_field"]["sigma_hit"] = 0.3
    cfg["sensor"] = "field_copy"  # a sensor model of its own file
    (tmp_path / "mclbench/sensors/field_copy.py").write_text(
        "from mclbench.sensors.likelihood_field import build, work  # noqa: F401\n")
    (tmp_path / "mclbench/configs/lf_wide.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "mclbench/traffic/track.json").read_text())
    mix["step"] = 150
    (tmp_path / "mclbench/traffic/quick.json").write_text(json.dumps(mix))
    (tmp_path / "mclbench/metrics/fleet_ticks_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.trace.ticks)\n")
    bench["configs"].append({"name": "lf_wide", "source": "test", "reduced": [],
                             "file": "mclbench/configs/lf_wide.json", "why": "test"})
    bench["workloads"].append({"name": "lf_wide.quick", "config": "lf_wide",
                               "traffic": "quick", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "fleet.ticks_traced", "unit": "ticks",
                               "better": "higher", "source": "program_span",
                               "layer": "fleet update", "moves": "tick_ms_p95",
                               "workloads": ["lf_wide.quick"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys, json; sys.path[:0] = [%r, %r]; from mclbench import harness; "
            "r = harness.run_cell('lf_wide.quick', 3, 0.1, True, device='cpu', robots=2, "
            "particles=32, log=lambda l: None); print(json.dumps(r))"
            % (str(tmp_path), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True, cwd=tmp_path).stdout
    r = json.loads(out.strip().splitlines()[-1])
    assert r["correct"] and r["metrics"]["fleet.ticks_traced"]["value"] == harness.TRACE_TICKS
    assert r["metrics"]["step_mfu"]["value"] > 0


def test_benchmark_file_keeps_to_its_limits():
    import re

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for w in bench["workloads"]:
        assert name.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
    for c in bench["configs"]:
        assert name.match(c["name"]) and len(c["source"]) <= 200 and len(c["why"]) <= 200
    cells = len(bench["workloads"])
    assert 2 + 14 * 24 <= 43200 and (bench["run_seconds"] + 60) * (2 + 14 * 24) \
        + 24 * 2 * 90 + 1200 <= 43200
    assert cells >= 1
