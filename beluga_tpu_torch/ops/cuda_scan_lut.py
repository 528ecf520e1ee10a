"""Kernel B9: the shared-scan correlation LUT build.

Port of ``beluga_tpu/ops/pallas_scan_lut.py:scan_lut_correlate``
(``csrc/scan_lut.cu``).  :func:`scan_lut_correlate` builds the maps from
the scan: on a CUDA tensor one launch of the kernel, which forms the
per-(θ bin, beam) tables in its prologue; on a CPU tensor the tables of
:func:`scan_lut_tables` (the reference's operations,
``pallas_scan_lut.py:98-126``) and :func:`correlate_reference`, the plain
PyTorch version.  :func:`correlate` takes the tables as inputs, so that a
test can feed the kernel the reference's own.

For bin k at heading ``θ_k = k · f32(2π/K)`` and beam b, the offset in
cells is ``o = R(θ_k) p_b / res``; ``ix, iy`` are its ``floor``
(bilinear) or ``round`` half to even (nearest); the shift is
``(mod(-iy, Hp), mod(-ix, Wp))`` and the weights ``(m, ax, ay)`` with
``ax = ox - ix``, ``ay = oy - iy`` (``0, 0`` for nearest).  Output cell
``(k, y, x)`` sums the field at ``((y + iy) mod Hp, (x + ix) mod Wp)``
over the beams, bilinearly or not (the sums are written out in
``csrc/scan_lut.cu``).  The kernel stages a window of the field, the
output tile grown by ``halo`` cells, in shared memory; shifts beyond it
are read from global memory, so any halo gives the same maps.

Contract: the kernel and the plain version take the same float32
operations in the same order, so they agree bit for bit on the same
tables, and the kernel's prologue forms the tables that
:func:`scan_lut_tables` forms on the same device: both take the bins'
``cos`` and ``sin`` from :func:`bin_trig` and divide by the resolution
rounded to float32 as a true division (never by a Python number on the
card, which CUDA would turn into a product with the reciprocal and so move
cell edges).
"""

from __future__ import annotations

import ctypes
import math

import torch

from beluga_tpu_torch.ops._build import Entry, stream_ptr, on_card

Tensor = torch.Tensor

SAMPLINGS = ("bilinear", "nearest")
MAX_CELLS = 2**31 - 1  # the kernel packs a cell index of the field into an int

# kernel launches since the count was last set to 0 (from tables or from
# the scan: one kernel)
launches = 0

_trig: dict[tuple[int, str], Tensor] = {}

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_from_tables = Entry("scan_lut", "beluga_scan_lut", [_p, _i, _i, _p, _p, _i, _i, _i, _i, _p, _p],
                     "scan_lut kernel launch")
_from_points = Entry("scan_lut", "beluga_scan_lut_points",
                     [_p, _i, _i, _p, _p, _p, _f, _i, _i, _i, _i, _p, _p], "scan_lut kernel launch")


def theta_bins(n_theta: int, device) -> Tensor:
    """Bin headings ``arange(K) · f32(2π / K)`` in float32, as the
    reference computes them."""
    step = torch.tensor(2.0 * math.pi / n_theta, dtype=torch.float32, device=device)
    return torch.arange(n_theta, dtype=torch.float32, device=device) * step


def bin_trig(n_theta: int, device) -> Tensor:
    """``f32[K, 2]``: ``cos`` and ``sin`` of :func:`theta_bins`, computed
    once per (K, device) and kept."""
    device = torch.device(device)
    key = (n_theta, str(device))
    trig = _trig.get(key)
    if trig is None:
        th = theta_bins(n_theta, device)
        trig = _trig[key] = torch.stack([torch.cos(th), torch.sin(th)], dim=-1).contiguous()
    return trig


def beam_offsets(points: Tensor, resolution: float, n_theta: int) -> tuple[Tensor, Tensor]:
    """Each beam's offset in cells at each bin heading, ``(ox, oy)``
    float32 ``[K, B]`` (pallas_scan_lut.py:98-101)."""
    trig = bin_trig(n_theta, points.device)
    c, s = trig[:, 0, None], trig[:, 1, None]
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
    if padded.numel() > MAX_CELLS:
        raise ValueError(f"{padded.numel()} field cells; the kernel takes at most {MAX_CELLS}")


def _halo(halo: int | None) -> int:
    """The kernel's halo argument: -1 asks for the largest window that
    shared memory holds."""
    return -1 if halo is None else max(int(halo), 0)


def correlate(padded: Tensor, shifts: Tensor, weights: Tensor, sampling: str = "bilinear",
              halo: int | None = None) -> Tensor:
    """The correlation maps ``f32[K, Hp, Wp]`` of ``padded`` from the
    tables of :func:`scan_lut_tables`: kernel B9 on a CUDA tensor, its plain
    version on a CPU tensor.  Shifts must lie in ``[0, Hp) x [0, Wp)``;
    ``halo`` (cells) sizes the kernel's shared-memory window, None for as
    large as fits; it changes no value."""
    global launches
    _check(padded, shifts, weights, sampling)
    if not on_card(padded.device):
        return correlate_reference(padded, shifts, weights, sampling)
    hp, wp = padded.shape
    k, nb, _ = shifts.shape
    out = torch.empty((k, hp, wp), dtype=torch.float32, device=padded.device)
    stream = stream_ptr(padded.device)
    _from_tables(padded.data_ptr(), hp, wp, shifts.data_ptr(), weights.data_ptr(), k, nb,
                 int(sampling == "bilinear"), _halo(halo), out.data_ptr(), stream)
    launches += 1
    return out


def scan_lut_correlate(padded: Tensor, points: Tensor, beam_mask: Tensor, resolution: float,
                       n_theta: int, sampling: str = "bilinear",
                       halo: int | None = None) -> Tensor:
    """Correlation maps ``f32[K, Hp, Wp]`` of the padded pz³ field with the
    scan (``points f32[B, 2]`` in the base frame, ``beam_mask bool[B]``):
    masked beams contribute nothing; shifts wrap around.  On the card one
    launch, the tables built in the kernel's prologue; ``halo`` is the
    padding of :func:`~beluga_tpu_torch.models.sensor.likelihood_field_lut.
    scan_lut_padded`, which bounds the scan's offsets (None: as large as
    fits)."""
    global launches
    if sampling not in SAMPLINGS:
        raise ValueError(f"unknown sampling: {sampling!r}")
    hp, wp = padded.shape
    if not on_card(padded.device):
        shifts, weights = scan_lut_tables(points, beam_mask, resolution, n_theta, hp, wp,
                                          sampling)
        return correlate(padded.contiguous(), shifts, weights, sampling)
    padded, points, beam_mask = padded.contiguous(), points.contiguous(), beam_mask.contiguous()
    nb = points.shape[0]
    if padded.dtype != torch.float32 or padded.dim() != 2:
        raise ValueError(f"padded must be float32[Hp, Wp], got {padded.dtype}{list(padded.shape)}")
    if padded.numel() > MAX_CELLS:
        raise ValueError(f"{padded.numel()} field cells; the kernel takes at most {MAX_CELLS}")
    if points.dtype != torch.float32 or tuple(points.shape) != (nb, 2):
        raise ValueError(f"points must be float32[B, 2], got {points.dtype}{list(points.shape)}")
    if beam_mask.dtype != torch.bool or tuple(beam_mask.shape) != (nb,):
        raise ValueError(f"beam_mask must be bool[{nb}], got "
                         f"{beam_mask.dtype}{list(beam_mask.shape)}")
    for name, t in (("points", points), ("beam_mask", beam_mask)):
        if t.device != padded.device:
            raise ValueError(f"{name} is on {t.device}, padded on {padded.device}")
    trig = bin_trig(n_theta, padded.device)
    out = torch.empty((n_theta, hp, wp), dtype=torch.float32, device=padded.device)
    stream = stream_ptr(padded.device)
    _from_points(padded.data_ptr(), hp, wp, points.data_ptr(), beam_mask.data_ptr(),
                 trig.data_ptr(), float(resolution), n_theta, nb, int(sampling == "bilinear"),
                 _halo(halo), out.data_ptr(), stream)
    launches += 1
    return out
