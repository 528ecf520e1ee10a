"""Kernel B2: fused resampling search and donor copy.

Port of ``beluga_tpu/ops/pallas_resample.py``: :func:`resample_take`, its
tree form and the sorted-multinomial form.  The kernel is
``csrc/resample.cu``.  :func:`resample_take` builds the CDF outside the
kernel, as in JAX, and hands it to :func:`search_take`, which launches the
kernel on CUDA tensors and runs :func:`resample_take_reference`, the plain
PyTorch version, on CPU tensors.

Contract: donor ``k`` of position ``u`` is the first slot with
``cdf[k] > u``; zero-weight slots are never chosen; a position at or above
the last CDF entry (padding ``u = 1.5``) gets a zero row; donor rows are
bit-exact copies.  Every input may carry leading filter axes: a fleet
passes weights ``[B, N]``, positions ``[B, M]`` and planes ``[B, D, N]``,
and each filter searches its own CDF.
"""

from __future__ import annotations

import ctypes
import math
from typing import Any

import torch

from beluga_tpu_torch.core.particles import tree_leaves, tree_map
from beluga_tpu_torch.ops.resample import interleave_slots, sorted_multinomial_positions

Tensor = torch.Tensor

# kernel launches since the count was last set to 0
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from beluga_tpu_torch.ops._build import load_library

        fn = load_library("resample").beluga_resample_take
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def monotone_cdf(weights: Tensor) -> Tensor:
    """``cummax(cumsum(w) / Σw)`` along the last axis, one CDF per filter
    (pallas_resample.py:405-412): a parallel cumsum can dip by an ulp, and
    the interval search needs a monotone CDF."""
    c = torch.cumsum(weights, dim=-1)
    cdf = c / torch.clamp_min(c[..., -1:], 1e-38)
    return torch.cummax(cdf, dim=-1).values


def resample_take_reference(cdf: Tensor, positions: Tensor, values: Tensor) -> Tensor:
    """Plain PyTorch version of the kernel: ``searchsorted`` (side right)
    and a gather; ``f32[..., M, D]``."""
    n, d = cdf.shape[-1], values.shape[-2]
    idx = torch.searchsorted(cdf, positions, right=True)
    found = idx < n
    safe = torch.clamp_max(idx, n - 1)[..., None, :].expand(*idx.shape[:-1], d, idx.shape[-1])
    rows = torch.take_along_dim(values, safe, dim=-1).transpose(-1, -2)
    return torch.where(found[..., None], rows, 0.0)


def _check(cdf: Tensor, positions: Tensor, values: Tensor) -> None:
    device = cdf.device
    for name, t in (("cdf", cdf), ("positions", positions), ("values", values)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, cdf on {device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cdf.dim() < 1 or cdf.shape[-1] == 0:
        raise ValueError(f"cdf must be float32[..., N], N > 0, got {list(cdf.shape)}")
    lead, n = tuple(cdf.shape[:-1]), cdf.shape[-1]
    if positions.shape[:-1] != lead or positions.dim() != cdf.dim():
        raise ValueError(f"positions must be float32{list(lead) + ['M']}, "
                         f"got {list(positions.shape)}")
    if values.dim() != cdf.dim() + 1 or values.shape[:-2] != lead or values.shape[-1] != n:
        raise ValueError(f"values must be float32{list(lead) + ['D', n]}, got {list(values.shape)}")
    if math.prod(lead) > 65535:
        raise ValueError(f"{math.prod(lead)} filters; the kernel takes at most 65535")


def search_take(cdf: Tensor, positions: Tensor, values: Tensor) -> Tensor:
    """The kernel's function on a monotone ``cdf`` f32[..., N]: donor rows
    ``f32[..., M, D]`` for ``positions`` f32[..., M] from ``values``
    f32[..., D, N].  Launches the kernel on CUDA tensors, runs the plain
    version on CPU tensors."""
    global launches
    _check(cdf, positions, values)
    if cdf.device.type == "cpu":
        return resample_take_reference(cdf, positions, values)
    if cdf.device.type != "cuda":
        raise ValueError(f"unsupported device {cdf.device}")
    d, n = values.shape[-2:]
    m = positions.shape[-1]
    out = torch.empty((*positions.shape, d), dtype=torch.float32, device=cdf.device)
    stream = torch.cuda.current_stream(cdf.device).cuda_stream
    err = _kernel()(cdf.data_ptr(), n, positions.data_ptr(), m, values.data_ptr(), d,
                    out.data_ptr(), math.prod(positions.shape[:-1]), stream)
    if err != 0:
        raise RuntimeError(f"resample kernel launch failed: cudaError {err}")
    launches += 1
    return out


def resample_take(weights: Tensor, positions: Tensor, values: Tensor) -> Tensor:
    """Donor states for every position.

    Args:
      weights: ``f32[..., N]`` linear weights (zero on dead slots).
      positions: ``f32[..., M]`` in [0, 1); ``1.5`` pads a slot that takes none.
      values: ``f32[..., D, N]`` state planes.
    Returns ``f32[..., M, D]``.
    """
    if (weights.dtype != torch.float32 or weights.dim() < 1
            or weights.shape[:-1] != positions.shape[:-1]):
        raise ValueError(f"weights must be float32 with the positions' filter axes, "
                         f"got {weights.dtype}{list(weights.shape)}")
    return search_take(monotone_cdf(weights), positions, values)


def pack_state(states: Any, batch_dims: int = 0) -> tuple[Tensor, Any]:
    """Flatten a state tree (leaves ``[..., N]`` or ``[..., N, k]`` after
    ``batch_dims`` filter axes) into ``f32[..., D, N]`` planes; returns the
    planes and the tree to unpack into."""
    leaves = tree_leaves(states)
    lead = tuple(leaves[0].shape[:batch_dims])
    n = leaves[0].shape[batch_dims]
    planes = torch.cat([leaf.reshape(*lead, n, -1).transpose(-1, -2).float()
                        for leaf in leaves], dim=-2)
    return planes.contiguous(), states


def unpack_state(packed: Tensor, like: Any) -> Any:
    """Inverse of :func:`pack_state` for ``packed`` ``f32[..., M, D]``,
    shaped like the tree ``like`` (with M particles in place of N)."""
    lead, m = tuple(packed.shape[:-2]), packed.shape[-2]
    b = len(lead)
    at = 0

    def take(leaf: Tensor) -> Tensor:
        nonlocal at
        trailing = tuple(leaf.shape[b + 1:])
        k = math.prod(trailing)
        out = packed[..., at : at + k].reshape(lead + (m,) + trailing)
        at += k
        return out

    return tree_map(take, like)


def resample_take_tree(weights: Tensor, positions: Tensor, states: Any) -> Any:
    """:func:`resample_take` over a state tree whose leaves carry the
    weights' filter axes."""
    packed, like = pack_state(states, weights.dim() - 1)
    return unpack_state(resample_take(weights, positions, packed), like)


def resample_take_tree_multinomial(
    generator: torch.Generator, weights: Tensor, states: Any, num: int,
    positions: Tensor | None = None, interleave: bool = True,
) -> Any:
    """Exact-multiset multinomial resample: sorted uniform order statistics
    (``positions``, drawn from ``generator`` when not given), the kernel,
    then, with ``interleave``, the slot interleave so slot prefixes cover
    the CDF uniformly.  Without it the donors stay in CDF order, which
    keeps theta-sorted slots sorted (pallas_resample.py:548-574)."""
    lead = tuple(weights.shape[:-1])
    if positions is None:
        positions = sorted_multinomial_positions(generator, num, lead)
    donors = resample_take_tree(weights, positions, states)
    if not interleave:
        return donors
    return tree_map(lambda leaf: interleave_slots(leaf, axis=len(lead)), donors)
