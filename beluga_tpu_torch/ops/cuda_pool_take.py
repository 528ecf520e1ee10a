"""Kernel B3: row take from a small per-filter pool.

Port of ``beluga_tpu/ops/pallas_lookup.py:pallas_pool_take``; the kernel
is ``csrc/pool_take.cu``.  :func:`pool_take` launches it on CUDA tensors
and runs :func:`pool_take_reference`, the plain PyTorch version, on CPU
tensors.  It serves the pooled recovery sampler
(``core/random.py:sample_uniform_free_cells_pooled``).

Contract: ``out[..., i, :] = pool[..., idx[..., i], :]`` as bit-exact
float32 copies; an index outside ``[0, P)`` gives a zero row (the one-hot
of the reference selects nothing for its ``-1`` padding).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

Tensor = torch.Tensor

MAX_POOL = 4096  # rows; the reference's one-hot budget, kept as the contract
MAX_COLS = 8

# kernel launches since the count was last set to 0
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from beluga_tpu_torch.ops._build import load_library

        fn = load_library("pool_take").beluga_pool_take
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def pool_take_reference(pool: Tensor, idx: Tensor) -> Tensor:
    """Plain PyTorch version of the kernel: a gather along the pool's row
    axis and a zero row where the index is out of range."""
    p, c = pool.shape[-2:]
    valid = (idx >= 0) & (idx < p)
    safe = torch.where(valid, idx, 0).long()
    rows = torch.take_along_dim(pool, safe[..., None].expand(*safe.shape, c), dim=-2)
    return torch.where(valid[..., None], rows, 0.0)


@functools.lru_cache(maxsize=64)
def _plan(pool, idx) -> tuple[int, int, int, int]:
    """The wrapper's checks on ``(shape, dtype, device, contiguous)`` of
    ``pool`` and ``idx`` (raising on what the kernel does not take), cached
    by them: ``(P, C, n, filters)``."""
    (pshape, pdtype, pdev, pcontig), (ishape, idtype, idev, icontig) = pool, idx
    if idev != pdev:
        raise ValueError(f"idx is on {idev}, pool on {pdev}")
    for name, contiguous in (("pool", pcontig), ("idx", icontig)):
        if not contiguous:
            raise ValueError(f"{name} must be contiguous")
    if pdtype != torch.float32 or len(pshape) < 2:
        raise ValueError(f"pool must be float32[..., P, C], got {pdtype}{list(pshape)}")
    p, c = pshape[-2:]
    if not (0 < p <= MAX_POOL and 0 < c <= MAX_COLS):
        raise ValueError(f"pool is [{p}, {c}]; the kernel takes P <= {MAX_POOL}, C <= {MAX_COLS}")
    if idtype != torch.int32 or ishape[:-1] != pshape[:-2]:
        raise ValueError(f"idx must be int32 with the pool's filter axes "
                         f"{list(pshape[:-2])} then n, got {idtype}{list(ishape)}")
    if pdev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {pdev}")
    batch = math.prod(ishape[:-1])
    if pdev.type == "cuda" and batch > 65535:
        raise ValueError(f"{batch} filters; the kernel takes at most 65535")
    return p, c, ishape[-1], batch


def pool_take(pool: Tensor, idx: Tensor) -> Tensor:
    """``pool[..., idx, :]``: ``f32[..., n, C]`` from ``pool`` ``f32[..., P, C]``
    and ``idx`` ``int32[..., n]`` (the leading filter axes agree).  The
    checks are cached by the tensors' shapes, dtypes, devices and
    contiguity."""
    global launches
    p, c, n, batch = _plan((pool.shape, pool.dtype, pool.device, pool.is_contiguous()),
                           (idx.shape, idx.dtype, idx.device, idx.is_contiguous()))
    if not pool.is_cuda:
        return pool_take_reference(pool, idx)
    out = torch.empty((*idx.shape, c), dtype=torch.float32, device=pool.device)
    stream = torch.cuda.current_stream(pool.device).cuda_stream
    err = _kernel()(pool.data_ptr(), p, c, idx.data_ptr(), n, batch, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pool_take kernel launch failed: cudaError {err}")
    launches += 1
    return out
