"""Kernel B9: the shared-scan correlation LUT build.

Port of ``beluga_tpu/ops/pallas_scan_lut.py:scan_lut_correlate``
(``csrc/scan_lut.cu``).  :func:`scan_lut_correlate` computes the per-(θ bin,
beam) tables with the reference's operations (:func:`scan_lut_tables`,
``pallas_scan_lut.py:98-126``) and hands them to :func:`correlate`, which
launches the kernel on CUDA tensors and runs :func:`correlate_reference`,
the plain PyTorch version, on CPU tensors.  The kernel core takes the
tables as inputs, so a test can feed it the reference's own.

For bin k at heading ``θ_k = k · f32(2π/K)`` and beam b, the offset in
cells is ``o = R(θ_k) p_b / res``; ``ix, iy`` are its ``floor``
(bilinear) or ``round`` half to even (nearest); the shift is
``(mod(-iy, Hp), mod(-ix, Wp))`` and the weights ``(m, ax, ay)`` with
``ax = ox - ix``, ``ay = oy - iy`` (``0, 0`` for nearest).  Output cell
``(k, y, x)`` sums the field at ``((y + iy) mod Hp, (x + ix) mod Wp)``
over the beams, bilinearly or not (the sums are written out in
``csrc/scan_lut.cu``).

Contract: the kernel and the plain version take the same float32
operations in the same order, so they agree bit for bit on the same
tables.  The division by the resolution is by a device tensor, never a
Python number (CUDA would multiply by the reciprocal and move cell edges).
"""

from __future__ import annotations

import ctypes
import math

import torch

Tensor = torch.Tensor

SAMPLINGS = ("bilinear", "nearest")
MAX_BEAMS = 8192  # shared memory: 20 bytes per beam

# kernel launches since the count was last set to 0
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from beluga_tpu_torch.ops._build import load_library

        fn = load_library("scan_lut").beluga_scan_lut
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, p, p, i, i, i, p, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def theta_bins(n_theta: int, device) -> Tensor:
    """Bin headings ``arange(K) · f32(2π / K)`` in float32, as the
    reference computes them."""
    step = torch.tensor(2.0 * math.pi / n_theta, dtype=torch.float32, device=device)
    return torch.arange(n_theta, dtype=torch.float32, device=device) * step


def beam_offsets(points: Tensor, resolution: float, n_theta: int) -> tuple[Tensor, Tensor]:
    """Each beam's offset in cells at each bin heading, ``(ox, oy)``
    float32 ``[K, B]`` (pallas_scan_lut.py:98-101)."""
    th = theta_bins(n_theta, points.device)
    c, s = torch.cos(th)[:, None], torch.sin(th)[:, None]
    px, py = points[None, :, 0], points[None, :, 1]
    res = torch.tensor(resolution, dtype=torch.float32, device=points.device)
    return (c * px - s * py) / res, (s * px + c * py) / res


def scan_lut_tables(points: Tensor, beam_mask: Tensor, resolution: float, n_theta: int,
                    hp: int, wp: int, sampling: str = "bilinear") -> tuple[Tensor, Tensor]:
    """``(shifts int32[K, B, 2], weights f32[K, B, 3])`` of the build
    (pallas_scan_lut.py:98-126)."""
    if sampling not in SAMPLINGS:
        raise ValueError(f"unknown sampling: {sampling!r}")
    ox, oy = beam_offsets(points, resolution, n_theta)
    m = beam_mask[None, :].to(torch.float32).expand(ox.shape)
    if sampling == "bilinear":
        fx, fy = torch.floor(ox), torch.floor(oy)
        weights = torch.stack([m, ox - fx, oy - fy], dim=-1)
    else:
        fx, fy = torch.round(ox), torch.round(oy)
        zero = torch.zeros_like(ox)
        weights = torch.stack([m, zero, zero], dim=-1)
    iy, ix = fy.to(torch.int64), fx.to(torch.int64)
    shifts = torch.stack([torch.remainder(-iy, hp), torch.remainder(-ix, wp)], dim=-1)
    return shifts.to(torch.int32).contiguous(), weights.contiguous()


def correlate_reference(padded: Tensor, shifts: Tensor, weights: Tensor,
                        sampling: str = "bilinear") -> Tensor:
    """Plain PyTorch version of kernel B9, ``f32[K, Hp, Wp]``: per beam,
    every bin's shifted image at once by index arithmetic, summed in beam
    order.  A beam masked in every bin is left out, as the kernel leaves
    out each masked (bin, beam): it would add +0 to the sums."""
    hp, wp = padded.shape
    k = shifts.shape[0]
    dev = padded.device
    ys = torch.arange(hp, device=dev)
    xs = torch.arange(wp, device=dev)
    m, ax, ay = (v[..., None, None] for v in weights.unbind(-1))  # [K, B, 1, 1]
    acc_u = torch.zeros((k, hp, wp), dtype=torch.float32, device=dev)
    acc_v = torch.zeros_like(acc_u) if sampling == "bilinear" else None
    for b in torch.nonzero((weights[..., 0] != 0).any(0)).flatten().tolist():
        rows = torch.remainder(ys[None, :] - shifts[:, b, 0, None], hp)[:, :, None]  # [K, Hp, 1]
        cols = torch.remainder(xs[None, :] - shifts[:, b, 1, None], wp)  # [K, Wp]
        r00 = padded[rows, cols[:, None, :]]
        if sampling == "nearest":
            acc_u = acc_u + m[:, b] * r00
            continue
        r01 = padded[rows, torch.remainder(cols + 1, wp)[:, None, :]]
        u = r00 + ax[:, b] * (r01 - r00)
        acc_u = acc_u + (m[:, b] * (1.0 - ay[:, b])) * u
        acc_v = acc_v + (m[:, b] * ay[:, b]) * u
    if sampling == "nearest":
        return acc_u
    return acc_u + torch.roll(acc_v, -1, dims=1)


def _check(padded, shifts, weights, sampling):
    if sampling not in SAMPLINGS:
        raise ValueError(f"unknown sampling: {sampling!r}")
    if padded.dtype != torch.float32 or padded.dim() != 2:
        raise ValueError(f"padded must be float32[Hp, Wp], got {padded.dtype}{list(padded.shape)}")
    if shifts.dtype != torch.int32 or shifts.dim() != 3 or shifts.shape[-1] != 2:
        raise ValueError(f"shifts must be int32[K, B, 2], got {shifts.dtype}{list(shifts.shape)}")
    k, nb, _ = shifts.shape
    if weights.dtype != torch.float32 or weights.shape != (k, nb, 3):
        raise ValueError(f"weights must be float32[{k}, {nb}, 3], got "
                         f"{weights.dtype}{list(weights.shape)}")
    for name, t in (("padded", padded), ("shifts", shifts), ("weights", weights)):
        if t.device != padded.device:
            raise ValueError(f"{name} is on {t.device}, padded on {padded.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if nb > MAX_BEAMS:
        raise ValueError(f"{nb} beams; the kernel takes at most {MAX_BEAMS}")
    if k > 65535:
        raise ValueError(f"{k} heading bins; the kernel takes at most 65535")


def correlate(padded: Tensor, shifts: Tensor, weights: Tensor,
              sampling: str = "bilinear") -> Tensor:
    """The correlation maps ``f32[K, Hp, Wp]`` of ``padded`` from the
    tables of :func:`scan_lut_tables`: kernel B9 on a CUDA tensor, its plain
    version on a CPU tensor.  Shifts must lie in ``[0, Hp) x [0, Wp)``."""
    global launches
    _check(padded, shifts, weights, sampling)
    if padded.device.type == "cpu":
        return correlate_reference(padded, shifts, weights, sampling)
    if padded.device.type != "cuda":
        raise ValueError(f"unsupported device {padded.device}")
    hp, wp = padded.shape
    k, nb, _ = shifts.shape
    out = torch.empty((k, hp, wp), dtype=torch.float32, device=padded.device)
    stream = torch.cuda.current_stream(padded.device).cuda_stream
    err = _kernel()(padded.data_ptr(), hp, wp, shifts.data_ptr(), weights.data_ptr(), k, nb,
                    int(sampling == "bilinear"), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"scan_lut kernel launch failed: cudaError {err}")
    launches += 1
    return out


def scan_lut_correlate(padded: Tensor, points: Tensor, beam_mask: Tensor, resolution: float,
                       n_theta: int, sampling: str = "bilinear") -> Tensor:
    """Correlation maps ``f32[K, Hp, Wp]`` of the padded pz³ field with the
    scan (``points f32[B, 2]`` in the base frame, ``beam_mask bool[B]``):
    masked beams contribute nothing; shifts wrap around."""
    hp, wp = padded.shape
    shifts, weights = scan_lut_tables(points, beam_mask, resolution, n_theta, hp, wp, sampling)
    return correlate(padded.contiguous(), shifts, weights, sampling)
