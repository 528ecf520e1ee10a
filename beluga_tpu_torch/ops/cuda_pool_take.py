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


def _check(pool: Tensor, idx: Tensor) -> None:
    if idx.device != pool.device:
        raise ValueError(f"idx is on {idx.device}, pool on {pool.device}")
    for name, t in (("pool", pool), ("idx", idx)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if pool.dtype != torch.float32 or pool.dim() < 2:
        raise ValueError(f"pool must be float32[..., P, C], got {pool.dtype}{list(pool.shape)}")
    p, c = pool.shape[-2:]
    if not (0 < p <= MAX_POOL and 0 < c <= MAX_COLS):
        raise ValueError(f"pool is [{p}, {c}]; the kernel takes P <= {MAX_POOL}, C <= {MAX_COLS}")
    if idx.dtype != torch.int32 or idx.shape[:-1] != pool.shape[:-2]:
        raise ValueError(f"idx must be int32 with the pool's filter axes "
                         f"{list(pool.shape[:-2])} then n, got {idx.dtype}{list(idx.shape)}")


def pool_take(pool: Tensor, idx: Tensor) -> Tensor:
    """``pool[..., idx, :]``: ``f32[..., n, C]`` from ``pool`` ``f32[..., P, C]``
    and ``idx`` ``int32[..., n]`` (the leading filter axes agree)."""
    global launches
    _check(pool, idx)
    if pool.device.type == "cpu":
        return pool_take_reference(pool, idx)
    if pool.device.type != "cuda":
        raise ValueError(f"unsupported device {pool.device}")
    p, c = pool.shape[-2:]
    n = idx.shape[-1]
    batch = math.prod(idx.shape[:-1])
    if batch > 65535:
        raise ValueError(f"{batch} filters; the kernel takes at most 65535")
    out = torch.empty((*idx.shape, c), dtype=torch.float32, device=pool.device)
    stream = torch.cuda.current_stream(pool.device).cuda_stream
    err = _kernel()(pool.data_ptr(), p, c, idx.data_ptr(), n, batch, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pool_take kernel launch failed: cudaError {err}")
    launches += 1
    return out
