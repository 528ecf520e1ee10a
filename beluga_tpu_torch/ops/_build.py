"""Build and load the hand-written CUDA kernels of ``beluga_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C launcher and is compiled at first
use with ``nvcc`` into its own shared library under
``build/beluga_tpu_torch/`` beside the package, named by a hash of the
source, the shared headers and the flags, then loaded with ``ctypes``.  No PyTorch header is
compiled, so a build takes seconds.  Importing this module needs neither
``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "beluga_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives: named by a
    hash of the source, every ``csrc/*.cuh`` header and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, Path(tmp), out


def _finish_build(name: str, job) -> str:
    """Waits for the build; returns nvcc's output (ptxas resource usage)."""
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    text = log.decode(errors="replace")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{text}")
    os.replace(tmp, out)
    return text


def build_all() -> dict[str, str]:
    """Compile every ``csrc/*.cu`` that has no current library, one
    ``nvcc`` per source, all started together.  Returns nvcc's output by
    source name (empty for a library that was already built)."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    jobs = {name: _start_build(name) for name in names}
    logs, errors = {}, []
    for name, job in jobs.items():  # wait for every nvcc before raising
        try:
            logs[name] = _finish_build(name, job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        _finish_build(name, _start_build(name))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
