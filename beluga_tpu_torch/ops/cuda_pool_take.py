"""Kernel B3: row take from a small per-filter pool, and the pooled
recovery sampler's whole draw.

Port of ``beluga_tpu/ops/pallas_lookup.py:pallas_pool_take``; the kernel
is ``csrc/pool_take.cu``, with two entries that share its device code.
:func:`pool_take` (the row entry, the counterpart of ``pallas_pool_take``)
and :func:`pooled_free_cells` (the draw entry, the pooled sampler's whole
draw, ``beluga_tpu/core/random.py:97-134``, which
``core/random.py:uniform_free_cells_pooled_from_draws`` calls) launch it on
CUDA tensors and run their plain PyTorch versions,
:func:`pool_take_reference` and :func:`pooled_free_cells_reference`, on CPU
tensors.

Contract: ``out[..., i, :] = pool[..., idx[..., i], :]`` as bit-exact
float32 copies; an index outside ``[0, P)`` gives a zero row (the one-hot
of the reference selects nothing for its ``-1`` padding).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from beluga_tpu_torch.lie import SE2, SO2
from beluga_tpu_torch.ops._build import Entry, stream_ptr, on_card

Tensor = torch.Tensor

MAX_POOL = 4096  # rows; the reference's one-hot budget, kept as the contract
MAX_COLS = 8

# kernel launches since the count was last set to 0: the row entry, the
# draw entry
launches = 0
draw_launches = 0

_p, _i = ctypes.c_void_p, ctypes.c_int
_take = Entry("pool_take", "beluga_pool_take", [_p, _i, _i, _p, _i, _i, _p, _p],
              "pool_take kernel launch")
_draw = Entry("pool_take", "beluga_pooled_free_cells",
              [_p, ctypes.c_longlong, _p, _i, _p, _p, _i, _i, _p, _p, _p],
              "pooled_free_cells kernel launch")


def pool_take_reference(pool: Tensor, idx: Tensor) -> Tensor:
    """Plain PyTorch version of the kernel: a gather along the pool's row
    axis and a zero row where the index is out of range."""
    p, c = pool.shape[-2:]
    valid = (idx >= 0) & (idx < p)
    safe = torch.where(valid, idx, 0).long()
    rows = torch.take_along_dim(pool, safe[..., None].expand(*safe.shape, c), dim=-2)
    return torch.where(valid[..., None], rows, 0.0)


@functools.lru_cache(maxsize=64)
def _plan(pool, idx) -> tuple[int, int, int, int, bool]:
    """The wrapper's checks on ``(shape, dtype, device, contiguous)`` of
    ``pool`` and ``idx`` (raising on what the kernel does not take), cached
    by them: ``(P, C, n, filters, whether the kernel runs)``."""
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
    kernel = on_card(pdev)
    batch = math.prod(ishape[:-1])
    if kernel and batch > 65535:
        raise ValueError(f"{batch} filters; the kernel takes at most 65535")
    return p, c, ishape[-1], batch, kernel


def pool_take(pool: Tensor, idx: Tensor) -> Tensor:
    """``pool[..., idx, :]``: ``f32[..., n, C]`` from ``pool`` ``f32[..., P, C]``
    and ``idx`` ``int32[..., n]`` (the leading filter axes agree).  The
    checks are cached by the tensors' shapes, dtypes, devices and
    contiguity."""
    global launches
    p, c, n, batch, kernel = _plan((pool.shape, pool.dtype, pool.device, pool.is_contiguous()),
                                   (idx.shape, idx.dtype, idx.device, idx.is_contiguous()))
    if not kernel:
        return pool_take_reference(pool, idx)
    out = torch.empty((*idx.shape, c), dtype=torch.float32, device=pool.device)
    stream = stream_ptr(pool.device)
    _take(pool.data_ptr(), p, c, idx.data_ptr(), n, batch, out.data_ptr(), stream)
    launches += 1
    return out


def pooled_free_cells_reference(free_xy: Tensor, cand: Tensor, idx: Tensor,
                                theta: Tensor) -> SE2:
    """Plain PyTorch version of the draw entry: the pool ``free_xy[cand]``
    (plain indexing, which wraps a negative ``cand`` and raises past the
    rows), :func:`pool_take_reference` on it and ``SO2.exp(theta)``."""
    return SE2(pool_take_reference(free_xy[cand], idx), SO2.exp(theta))


@functools.lru_cache(maxsize=64)
def _draw_plan(free_xy, cand, idx, theta) -> tuple[int, int, int, int, bool]:
    """The draw entry's checks on its tensors' ``(shape, dtype, device,
    contiguous)`` (raising on what the kernel does not take), cached by
    them: ``(rows, P, n, filters, whether the kernel runs)``."""
    tensors = {"free_xy": free_xy, "cand": cand, "idx": idx, "theta": theta}
    device = free_xy[2]
    for name, (_, _, dev, contiguous) in tensors.items():
        if dev != device:
            raise ValueError(f"{name} is on {dev}, free_xy on {device}")
        if not contiguous:
            raise ValueError(f"{name} must be contiguous")
    kernel = on_card(device)
    (fshape, fdtype, _, _), (cshape, cdtype, _, _) = free_xy, cand
    (ishape, idtype, _, _), (tshape, tdtype, _, _) = idx, theta
    if fdtype != torch.float32 or len(fshape) != 2 or fshape[1] != 2:
        raise ValueError(f"free_xy must be float32[rows, 2], got {fdtype}{list(fshape)}")
    if cdtype != torch.int64 or len(cshape) < 1 or not 0 < cshape[-1] <= MAX_POOL:
        raise ValueError(f"cand must be int64[..., P] with 0 < P <= {MAX_POOL}, "
                         f"got {cdtype}{list(cshape)}")
    lead = tuple(cshape[:-1])
    if idtype != torch.int32 or len(ishape) < 1 or tuple(ishape[:-1]) != lead:
        raise ValueError(f"idx must be int32 with cand's filter axes {list(lead)} then n, "
                         f"got {idtype}{list(ishape)}")
    if tdtype != torch.float32 or tuple(tshape) != tuple(ishape):
        raise ValueError(f"theta must be float32{list(ishape)}, got {tdtype}{list(tshape)}")
    batch = math.prod(lead)
    if kernel and batch > 65535:
        raise ValueError(f"{batch} filters; the kernel takes at most 65535")
    return fshape[0], cshape[-1], ishape[-1], batch, kernel


def pooled_free_cells(free_xy: Tensor, cand: Tensor, idx: Tensor, theta: Tensor) -> SE2:
    """The pooled recovery draw in one launch: SE2 states
    ``free_xy[cand][..., idx, :]`` with rotation ``(cos θ, sin θ)``.

    Args:
      free_xy: ``f32[rows, 2]`` free-cell centroids.
      cand: ``int64[..., P]`` pool rows of ``free_xy`` per filter, as
        ``torch.randint`` makes them (P <= 4096).
      idx: ``int32[..., n]`` pool entries, the same filter axes.
      theta: ``f32[..., n]`` headings.

    Returns ``SE2`` with ``xy`` and ``rot.z`` ``f32[..., n, 2]``, the two
    outputs of the kernel.  An ``idx`` outside ``[0, P)`` gives a zero
    translation row (the row entry's contract); the kernel reads no
    ``cand`` outside ``[0, rows)`` and gives a zero translation where such a
    pool entry is taken (the plain version's indexing wraps a negative
    ``cand`` and raises past the rows instead).  The checks are cached by
    the tensors' shapes, dtypes, devices and contiguity.
    """
    global draw_launches
    rows, p, n, batch, kernel = _draw_plan(*((t.shape, t.dtype, t.device, t.is_contiguous())
                                             for t in (free_xy, cand, idx, theta)))
    if not kernel:
        return pooled_free_cells_reference(free_xy, cand, idx, theta)
    xy = torch.empty((*idx.shape, 2), dtype=torch.float32, device=free_xy.device)
    z = torch.empty_like(xy)
    stream = stream_ptr(free_xy.device)
    _draw(free_xy.data_ptr(), rows, cand.data_ptr(), p, idx.data_ptr(), theta.data_ptr(), n,
          batch, xy.data_ptr(), z.data_ptr(), stream)
    draw_launches += 1
    return SE2(xy, SO2(z))
