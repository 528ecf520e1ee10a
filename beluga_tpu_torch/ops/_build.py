"""Build and load the hand-written CUDA kernels of ``beluga_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C launcher and is compiled at first
use with ``nvcc`` into its own shared library under
``build/beluga_tpu_torch/`` beside the package, named by a hash of the
source, the shared headers and the flags, then loaded with ``ctypes``.  No
PyTorch header is compiled, so a build takes seconds.  Importing this
module needs neither ``nvcc`` nor a GPU.

A wrapper in ``ops/`` declares each C entry it calls as a module-level
:class:`Entry`: library, symbol, ``argtypes`` (every entry returns its
``cudaError_t`` as ``int``), the name its error gives the call, and in
``expect`` the library's constants the wrapper plans for.  Declaring loads
nothing; the entry binds on its first call (building and loading the
library, checking those constants once), and each call launches and raises
``RuntimeError("<what> failed: cudaError <n>")`` on a nonzero return.  The
launch's stream (:func:`stream_ptr`) is the last argument.  A wrapper
sends a tensor's device through :func:`on_card`: CUDA to the kernel,
CPU to the plain PyTorch version, any other refused; :func:`row_stride`
is the layout check of the wrappers whose kernels take filter rows apart.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Any

import torch

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


def stream_ptr(device: torch.device) -> int:
    """The handle of ``device``'s current CUDA stream, for a launch: what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without making
    a ``Stream`` object (a few µs of host time a call)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


class Entry:
    """The C entry ``int symbol(argtypes...)`` of ``csrc/<library>.cu``,
    bound at its first call or :meth:`bind`, when each ``int name(void)``
    of ``expect`` must return its value there.  A nonzero return raises: a
    launch the card refused (too large a cooperative grid: 720) never ran."""

    __slots__ = ("library", "symbol", "argtypes", "what", "expect", "_fn")

    def __init__(self, library: str, symbol: str, argtypes: list, what: str,
                 expect: dict[str, int] | None = None):
        self.library, self.symbol, self.argtypes, self.what = library, symbol, argtypes, what
        self.expect = expect or {}
        self._fn = None

    @property
    def bound(self) -> bool:
        return self._fn is not None

    def bind(self) -> Any:
        """The ``ctypes`` function, bound once."""
        if self._fn is None:
            lib = load_library(self.library)
            for name, want in self.expect.items():
                constant = getattr(lib, name)
                constant.argtypes, constant.restype = [], ctypes.c_int
                if constant() != want:
                    raise RuntimeError(f"csrc/{self.library}.cu's {name}() is {constant()}, "
                                       f"the wrapper plans for {want}")
            fn = getattr(lib, self.symbol)
            fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, *args) -> None:
        err = (self._fn or self.bind())(*args)
        if err != 0:
            raise RuntimeError(f"{self.what} failed: cudaError {err}")


def on_card(device: torch.device) -> bool:
    """Whether tensors on ``device`` go to the kernel (CUDA) rather than to
    the plain PyTorch version (CPU); any other device raises."""
    if device.type == "cuda":
        return True
    if device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return False


def row_stride(shape, strides, lead: int, inner: tuple[int, ...], name: str) -> int:
    """The stride from one filter's row to the next of a tensor shaped
    ``shape[:lead]`` filters of rows ``shape[lead:]``, which must be
    contiguous (``inner`` their strides): one stride for every filter axis
    (0 where broadcast), else a ``ValueError``."""
    for size, stride, want in zip(shape[lead:], strides[lead:], inner):
        if size > 1 and stride != want:
            raise ValueError(f"{name} must be contiguous along its particle axis, got strides "
                             f"{list(strides)} for shape {list(shape)}")
    step, span = None, None
    for size, stride in reversed(list(zip(shape[:lead], strides[:lead]))):
        if size == 1:
            continue
        if step is None:
            step = stride
        elif stride != span:
            raise ValueError(f"{name}'s filter axes do not flatten to one stride: strides "
                             f"{list(strides)} for shape {list(shape)}")
        span = stride * size
    return 0 if step is None else step
