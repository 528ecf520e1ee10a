"""Kernel B7: the windowed range-LUT beam reweight.

Port of ``beluga_tpu/ops/pallas_beam_lut.py`` (``csrc/beam_lut.cu``):
:func:`beam_lut_windowed` launches the kernel on CUDA tensors and runs
:func:`beam_lut_windowed_reference`, the plain PyTorch version, on CPU
tensors.  The fleet form is leading filter axes (``[F, N]`` particles,
``[F, nb]`` beams), as kernels B1 and B2 take them; the LUT is shared.

The reference's contract is part of the function:
  * each filter's slots are cut into tiles of 4096, each tile into the
    blocks ``(0, 3840)`` and ``(3840, 256)`` (pallas_reweight.py:91, 113);
    slots past N are padding and are excluded from every statistic;
  * each (filter, tile, block) gets a window of 40 x 128 cells about the
    truncated mean cell of its valid slots, ``x0 = clip(cx - 20, 0, Wq -
    40)``, ``y0 = 64 * clip((cy - 64 + 32) // 64, 0, (Hq - 128) // 64)``
    (pallas_beam_lut.py:256-281); the block sums are integers and exact;
  * a particle whose cell lies outside its block's window reads the LUT's
    ``max_range`` in every bin; inside, ``bf16(ranges[k, yi, xi])``;
  * per beam, ``z_mean`` blends bins ``k0 = floor(mod(θ + β, 2π) / 2π ·
    K) mod K`` and ``k1 = (k0 + 1) mod K``; the mixture adds ``where(mask,
    pz³, 0)``.
The reference's banded stage 2 and its θ gate only schedule the same
two-row select; the port always takes the full-K select.  Its twin table
and x-major order serve Mosaic; the port's LUT is ``bf16[Hq, Wq, K]``,
cell-major, zero-padded to the reference's padded dims, so that a covered
cell past the map reads 0 in both.

Kernel and plain version run the same float32 operations in the same
order: the selected ranges are the same entries and the weights agree bit
for bit on the card.
"""

from __future__ import annotations

import ctypes
import math

import torch

from beluga_tpu_torch.ops.cuda_beam import Mixture, masked_beam_sum, mixture, mixture_pz3
from beluga_tpu_torch.ops.cuda_winlut import floor_mod

Tensor = torch.Tensor

TILE = 4096  # pallas_reweight.py:_TILE
BLOCKS = ((0, 3840), (3840, 256))  # pallas_reweight.py:_BLOCKS
CWX, CWY = 40, 128  # pallas_beam_lut.py:54-55
TWO_PI = 6.283185307179586  # 2π, rounded to float32 on the device as jnp.float32(2π)
MAX_FILTERS = 65535  # grid.y
MAX_BEAMS = 18000  # shared memory: 12 B a beam

# kernel launches since the count was last set to 0
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from beluga_tpu_torch.ops._build import load_library

        fn = load_library("beam_lut").beluga_beam_lut
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, i, i, i, f, p, p, p, i, p, i, p, p, p, i, i, p, p, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def padded_dims(h: int, w: int) -> tuple[int, int]:
    """``(Hq, Wq)``: the reference's padded LUT dims (pallas_beam_lut.py:
    431-432), at least one window each."""
    return max(-(-h // 128) * 128, CWY), max(w, CWX)


def build_lut_bf16(ranges: Tensor) -> Tensor:
    """``f32[K, H, W]`` range LUT → kernel B7's ``bf16[Hq, Wq, K]``,
    cell-major and zero-padded (``build_lut_bf16`` rounds to bf16 to
    nearest even, as here)."""
    k, h, w = ranges.shape
    hq, wq = padded_dims(h, w)
    out = torch.zeros((hq, wq, k), dtype=torch.bfloat16, device=ranges.device)
    out[:h, :w] = ranges.permute(1, 2, 0).to(torch.bfloat16)
    return out


def beam_mixture(mix) -> Mixture:
    """The kernel's mixture scalars from the reference's ``mix = (z_hit,
    z_short, z_rand, z_max, sigma_hit, lambda_short, beam_max_range)``
    (pallas_beam_lut.py:76-83, beam_lut.py:132-136)."""
    z_hit, z_short, z_rand, z_max, sigma, lam, bmr = (float(v) for v in mix)
    return mixture(z_hit, z_short, z_max, z_rand, sigma, lam, bmr)


def window_origins(xi: Tensor, yi: Tensor, hq: int, wq: int) -> Tensor:
    """``int32[F, tiles, 2, 2]``: ``(x0, y0)`` of each (filter, tile,
    block) from the integer cells ``xi``, ``yi`` ``[F, N]``.  The block sums
    of the valid slots are integers, exact in float32 below 2^24 as the
    reference sums them, and the mean is a float32 division by a tensor,
    truncated toward zero as ``astype(int32)`` does."""
    f, n = xi.shape
    tiles = -(-n // TILE)
    pad = tiles * TILE - n
    dev = xi.device
    valid = (torch.arange(tiles * TILE, device=dev) < n).reshape(tiles, TILE).to(torch.int64)

    def block_means(v):
        vt = torch.nn.functional.pad(v.to(torch.int64), (0, pad)).reshape(f, tiles, TILE)
        means = []
        for s, size in BLOCKS:
            total = torch.sum(vt[..., s:s + size] * valid[:, s:s + size], dim=-1)
            count = torch.sum(valid[:, s:s + size], dim=-1).expand(f, tiles)
            means.append(total.to(torch.float32) / torch.clamp_min(count, 1).to(torch.float32))
        return torch.stack(means, dim=-1).to(torch.int32)  # [F, tiles, 2]

    cx, cy = block_means(xi), block_means(yi)
    x0 = torch.clamp(cx - CWX // 2, 0, wq - CWX)
    y0 = 64 * torch.clamp(torch.div(cy - CWY // 2 + 32, 64, rounding_mode="floor"),
                          0, (hq - CWY) // 64)
    return torch.stack([x0, y0], dim=-1).to(torch.int32).contiguous()


def _per_slot(origins: Tensor, n: int) -> tuple[Tensor, Tensor]:
    """Each slot's window origin ``(x0, y0)`` ``[F, N]``."""
    slot = torch.arange(n, device=origins.device)
    tile, blk = slot // TILE, (slot % TILE >= BLOCKS[1][0]).long()
    o = origins[:, tile, blk]  # [F, N, 2]
    return o[..., 0], o[..., 1]


def beam_lut_windowed_reference(lut_bf16: Tensor, theta: Tensor, xi: Tensor, yi: Tensor,
                                z: Tensor, bearing: Tensor, beam_mask: Tensor, max_range,
                                mix) -> Tensor:
    """Plain PyTorch version of kernel B7 on ``[F, N]`` particles."""
    hq, wq, k = lut_bf16.shape
    dev = theta.device
    x0, y0 = _per_slot(window_origins(xi, yi, hq, wq), theta.shape[-1])
    covered = (xi >= x0) & (xi < x0 + CWX) & (yi >= y0) & (yi < y0 + CWY)
    two_pi = torch.tensor(TWO_PI, dtype=torch.float32, device=dev)
    ft = floor_mod(theta[..., :, None] + bearing[..., None, :], two_pi) / two_pi * k
    fl = torch.floor(ft)
    k0 = torch.remainder(torch.nan_to_num(fl).long(), k)  # a masked NaN beam reads bin 0
    k1 = torch.remainder(k0 + 1, k)
    a = ft - fl
    cell = (torch.where(covered, yi, 0).long() * wq + torch.where(covered, xi, 0).long()) * k
    flat = lut_bf16.reshape(-1)
    miss = torch.tensor(float(max_range), dtype=torch.float32, device=dev)
    r0 = torch.where(covered[..., None], flat[cell[..., None] + k0].float(), miss)
    r1 = torch.where(covered[..., None], flat[cell[..., None] + k1].float(), miss)
    z_mean = (1.0 - a) * r0 + a * r1
    pz3 = mixture_pz3(z[..., None, :], z_mean, beam_mixture(mix))
    return masked_beam_sum(pz3, beam_mask[..., None, :])


def _check(lut_bf16, theta, xi, yi, z, bearing, beam_mask):
    if lut_bf16.dtype != torch.bfloat16 or lut_bf16.dim() != 3:
        raise ValueError(f"lut_bf16 must be bfloat16[Hq, Wq, K], got "
                         f"{lut_bf16.dtype}{list(lut_bf16.shape)}")
    hq, wq, _ = lut_bf16.shape
    if hq < CWY or hq % 64 or wq < CWX:
        raise ValueError(f"lut_bf16 dims [{hq}, {wq}] are not padded as build_lut_bf16 pads")
    shape = theta.shape
    if theta.dim() != 2:
        raise ValueError("theta must be float32[F, N]")
    nb = z.shape[-1]
    want = {"theta": (shape, torch.float32), "xi": (shape, torch.int32),
            "yi": (shape, torch.int32), "z": ((shape[0], nb), torch.float32),
            "bearing": ((shape[0], nb), torch.float32),
            "beam_mask": ((shape[0], nb), torch.bool)}
    for (name, (shp, dtype)), t in zip(want.items(), (theta, xi, yi, z, bearing, beam_mask)):
        if t.device != lut_bf16.device:
            raise ValueError(f"{name} is on {t.device}, lut_bf16 on {lut_bf16.device}")
        if t.dtype != dtype or tuple(t.shape) != tuple(shp):
            raise ValueError(f"{name} must be {dtype}{list(shp)}, got {t.dtype}{list(t.shape)}")
    if nb > MAX_BEAMS:
        raise ValueError(f"{nb} beams; the kernel takes at most {MAX_BEAMS}")
    if shape[0] > MAX_FILTERS:
        raise ValueError(f"{shape[0]} filters; the kernel takes at most {MAX_FILTERS}")


def beam_lut_windowed(lut_bf16: Tensor, theta: Tensor, xi: Tensor, yi: Tensor, z: Tensor,
                      bearing: Tensor, beam_mask: Tensor, max_range, mix) -> Tensor:
    """Beam weights ``Σ_b pz_b³`` through windowed LUT reads, ``f32[..., N]``.

    Args:
      lut_bf16: ``bf16[Hq, Wq, K]`` from :func:`build_lut_bf16`.
      theta: ``f32[..., N]`` grid-local headings; xi/yi: ``int32[..., N]``
        cells.
      z/bearing: ``f32[..., nb]`` measured ranges and bearings; beam_mask:
        ``bool[..., nb]``, with the particles' filter axes.
      max_range: the LUT's max range (what an uncovered cell reads).
      mix: ``(z_hit, z_short, z_rand, z_max, sigma_hit, lambda_short,
        beam_max_range)``.
    """
    global launches
    lead = tuple(theta.shape[:-1])
    f = math.prod(lead)
    flat = [v.reshape(f, v.shape[-1]).contiguous() for v in (theta, xi, yi, z, bearing,
                                                               beam_mask)]
    _check(lut_bf16, *flat)
    theta2, xi2, yi2, z2, bearing2, mask2 = flat
    if lut_bf16.device.type == "cpu":
        out = beam_lut_windowed_reference(lut_bf16, *flat, max_range, mix)
        return out.reshape(theta.shape)
    if lut_bf16.device.type != "cuda":
        raise ValueError(f"unsupported device {lut_bf16.device}")
    hq, wq, k = lut_bf16.shape
    n, nb = theta2.shape[-1], z2.shape[-1]
    origins = window_origins(xi2, yi2, hq, wq)
    m = beam_mixture(mix)
    host = (ctypes.c_float * len(m))(*m)
    out = torch.empty((f, n), dtype=torch.float32, device=theta.device)
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    err = _kernel()(lut_bf16.data_ptr(), hq, wq, k, float(max_range), theta2.data_ptr(),
                    xi2.data_ptr(), yi2.data_ptr(), n, origins.data_ptr(), origins.shape[1],
                    z2.data_ptr(), bearing2.data_ptr(), mask2.data_ptr(), nb, f, host,
                    out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"beam LUT kernel launch failed: cudaError {err}")
    launches += 1
    return out.reshape(theta.shape)
