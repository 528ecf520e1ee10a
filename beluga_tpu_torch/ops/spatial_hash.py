"""Spatial hashing for KLD buckets and clustering (port of
``beluga_tpu/ops/spatial_hash.py``).

Each coordinate is floored at its resolution, Fibonacci-hashed, rotated
left by ``bits * index`` and XOR-folded, in 32 bits
(spatial_hash.hpp:44-273).  PyTorch has no general uint32 arithmetic, so
the 32-bit values are held in int64 tensors in ``[0, 2^32)``; they are only
ever compared for equality.
"""

from __future__ import annotations

from typing import Sequence

import torch

Tensor = torch.Tensor

_FIB32 = 2654435769  # 2^32 / golden ratio
_MASK32 = 0xFFFFFFFF


def _mul32(v: Tensor, c: int) -> Tensor:
    """``(v * c) mod 2^32`` for ``v`` in ``[0, 2^32)`` without int64
    overflow: ``c`` is split into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (v * lo + (((v * hi) & 0xFFFF) << 16)) & _MASK32


def _floor_fibo_hash(value: Tensor, bits: int, index: int) -> Tensor:
    """floor → int32 → its uint32 bits → Fibonacci spread → rotate left."""
    v = torch.floor(value).to(torch.int32).to(torch.int64) & _MASK32
    h = _mul32(v, _FIB32)
    shift = (bits * index) % 32
    if shift == 0:
        return h
    return ((h << shift) & _MASK32) | (h >> (32 - shift))


def hash_components(components: Sequence[Tensor], resolutions: Sequence[float]) -> Tensor:
    """XOR-fold of the per-axis hashes of ``components[i] / resolutions[i]``
    with ``bits = 32 // len(components)`` (spatial_hash.hpp:87-94).  The
    division is by a tensor on the component's device, as in float32 JAX."""
    bits = 32 // len(components)
    out = None
    for i, (c, r) in enumerate(zip(components, resolutions)):
        res = torch.full((), r, dtype=torch.float32, device=c.device)
        h = _floor_fibo_hash(c / res, bits, i)
        out = h if out is None else out ^ h
    return out


def spatial_hash_se2(xy: Tensor, theta: Tensor, res_xy: float, res_theta: float,
                     res_y: float | None = None) -> Tensor:
    """Hash SE2 states on (x, y, theta) (spatial_hash.hpp:160-197); int64
    values in ``[0, 2^32)``."""
    if res_y is None:
        res_y = res_xy
    return hash_components([xy[..., 0], xy[..., 1], theta], [res_xy, res_y, res_theta])
