"""Kernel B10, the NDT cell probe, and its redesign for the card, the
fused NDT stencil likelihood.

Both replace ``beluga_tpu/ops/pallas_ndt.py:ndt_probe``.  B10
(``csrc/ndt_probe.cu``): :func:`ndt_probe` launches it on CUDA tensors and
runs :func:`ndt_probe_reference`, the plain PyTorch version, on CPU
tensors; it serves ``maps/ndt.py:NdtMap.lookup_gaussians`` and the NDT
model's ``ndt_likelihood_at``.  The NDT sensor model's weights on the
stencil probe path (maps of more than 256 rows, or a stencil of its own)
go through the fused kernel instead (``csrc/ndt_weights.cu``):
:func:`ndt_weights` computes each particle's whole weight in one launch,
and :func:`ndt_weights_reference`, its plain version, is the chunked probe
path (:func:`probe_likelihood`) with B10's plain version as its probe.
Given the map's cell index (``maps/ndt.py:CellIndex``), the fused kernel
finds each probe's row by its address in the index; without one, by a
binary search of the sorted keys.

B10's contract: ``queries`` are encoded cell keys; each is matched exactly
against the map's sorted live keys ``keys[:num_cells]``; a match fetches
that row of ``values`` ``f32[M, P]`` (the cell's mean, then its flattened
covariance) as bit-exact float32 copies, and no match gives zeros and
``found = False``.  Keys are 32-bit unsigned values: this module and the
plain version hold them in int64 tensors in ``[0, 2^32)`` (PyTorch's
``uint32`` has few operators), and the kernels take them as ``uint32_t``
(their low 32 bits, through an int32 tensor of the same bits).

The fused kernel's contract: the plain version's world means and cell
keys exactly (the same float32 operations in the same order, the same
division by the resolution), the rest within rtol 1e-4 of the particle
weight: the kernel sums the stencil and the cells in another order, and in
3D inverts ``Σa + Σb + 1e-12·I`` by its adjugate where the plain version
takes the library's LU inverse, so the two part on a total covariance
that is singular or nearly so (the adjugate's determinant goes to 0, LU
pivots in another order).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from beluga_tpu_torch.ops._build import Entry, stream_ptr, on_card

Tensor = torch.Tensor

MAX_OFFSETS = 32  # stencil cells, passed by value
MAX_SLOTS = 32768  # measurement slots a filter: their live list in shared memory
MAX_FILTERS = 65535  # grid.y
MAX_INDEX_CELLS = 1 << 15  # the cell index in shared memory (maps/ndt.py:INDEX_MAX_CELLS)

# kernel launches since the count was last set to 0: B10, the fused kernel,
# and those of its launches that probed the map by address (its cell index)
launches = 0
weights_launches = 0
weights_indexed_launches = 0

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_probe = Entry("ndt_probe", "beluga_ndt_probe",
               [_p, _i, _p, _i, _p, ctypes.c_longlong, _p, _p, _p], "ndt_probe kernel launch")
_weights = Entry("ndt_weights", "beluga_ndt_weights",
                 [_p, _i, _p, _i, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _p, _i, _f, _f, _f,
                  _f, _p, _p],
                 "ndt_weights kernel launch")


def ndt_probe_reference(keys: Tensor, values: Tensor, num_cells: int,
                        queries: Tensor) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version of the kernel: ``torch.searchsorted`` of the
    int64 queries in the live keys, then a row gather."""
    live = keys[:num_cells]
    p = values.shape[-1]
    if num_cells == 0:
        return (torch.zeros((*queries.shape, p), dtype=torch.float32, device=values.device),
                torch.zeros(queries.shape, dtype=torch.bool, device=values.device))
    idx = torch.clamp_max(torch.searchsorted(live, queries), num_cells - 1)
    found = live[idx] == queries
    rows = values[idx]
    return torch.where(found[..., None], rows, 0.0), found


def _check(keys: Tensor, values: Tensor, num_cells: int, queries: Tensor) -> None:
    for name, t in (("values", values), ("queries", queries)):
        if t.device != keys.device:
            raise ValueError(f"{name} is on {t.device}, keys on {keys.device}")
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise ValueError(f"keys must be int64[M], got {keys.dtype}{list(keys.shape)}")
    if queries.dtype != torch.int64:
        raise ValueError(f"queries must be int64 keys, got {queries.dtype}")
    if values.dtype != torch.float32 or values.dim() != 2 or values.shape[0] != keys.shape[0]:
        raise ValueError(f"values must be float32[{keys.shape[0]}, P], got "
                         f"{values.dtype}{list(values.shape)}")
    if not 0 <= num_cells <= keys.shape[0]:
        raise ValueError(f"num_cells {num_cells} outside [0, {keys.shape[0]}]")


def ndt_probe(keys: Tensor, values: Tensor, num_cells: int,
              queries: Tensor) -> tuple[Tensor, Tensor]:
    """``(f32[..., P] values, bool[...] found)`` for the int64 ``queries``
    ``[...]`` against the sorted int64 ``keys`` ``[M]`` of which the first
    ``num_cells`` are live, with ``values`` ``f32[M, P]``."""
    global launches
    _check(keys, values, num_cells, queries)
    if not on_card(keys.device):
        return ndt_probe_reference(keys, values, num_cells, queries)
    p = values.shape[1]
    # the keys' low 32 bits as int32 (the conversion wraps), read by the
    # kernel as uint32_t
    q32 = queries.to(torch.int32).contiguous()
    k32 = keys.to(torch.int32).contiguous()
    vals = values.contiguous()
    out = torch.empty((*queries.shape, p), dtype=torch.float32, device=keys.device)
    found = torch.empty(queries.shape, dtype=torch.uint8, device=keys.device)
    stream = stream_ptr(keys.device)
    _probe(k32.data_ptr(), num_cells, vals.data_ptr(), p, q32.data_ptr(), q32.numel(),
           out.data_ptr(), found.data_ptr(), stream)
    launches += 1
    return out, found.view(torch.bool)


# -- the fused NDT stencil likelihood ------------------------------------------


def _matmul(a: Tensor, b: Tensor) -> Tensor:
    """Batched product of small matrices as broadcast sums (no library
    call for D <= 3)."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def world_gaussians(rot: Tensor, trans: Tensor, means: Tensor, covs: Tensor):
    """The measurement Gaussians ``means`` ``f32[..., C, D]``, ``covs``
    ``f32[..., C, D, D]`` as each pose (``rot`` ``f32[..., n, D, D]``,
    ``trans`` ``f32[..., n, D]``) sees them in the world
    (ndt_cell.hpp:63-68): means ``R m + t`` ``f32[..., n, C, D]``, each
    row summed left to right and the translation added last, and
    covariances ``R Σ Rᵀ`` ``f32[..., n, C, D, D]``."""
    r = rot[..., :, None, :, :]  # [..., n, 1, D, D]
    m = means[..., None, :, :]  # [..., 1, C, D]
    mean_w = r[..., :, 0] * m[..., 0:1]
    for j in range(1, means.shape[-1]):
        mean_w = mean_w + r[..., :, j] * m[..., j:j + 1]
    mean_w = mean_w + trans[..., :, None, :]
    cov_w = _matmul(_matmul(r, covs[..., None, :, :, :]), r.transpose(-1, -2))
    return mean_w, cov_w


def inv_2x2(m: Tensor) -> Tensor:
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    det = a * d - b * c
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    adj = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2)
    return adj * inv_det[..., None, None]


def inv_3x3(m: Tensor) -> Tensor:
    """``inv(m + 1e-12·I)`` through the library's batched inverse, without
    its error check (which would read a flag back from the card); a
    singular matrix gives inf or NaN, as ``jnp.linalg.inv`` does."""
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    return torch.linalg.inv_ex(m + 1e-12 * eye).inverse


def stencil_likelihood(mean_w: Tensor, cov_w: Tensor, map_mean: Tensor, map_cov: Tensor,
                       found: Tensor, d1: float, d2: float) -> Tensor:
    """``Σ_k found·d1·exp(-d2/2 · eᵀ(Σa + Σb)⁻¹e)`` over the stencil axis of
    the looked-up map Gaussians (``map_mean`` ``f32[..., K, D]``,
    ``map_cov`` ``f32[..., K, D, D]``, ``found`` ``bool[..., K]``) for query
    Gaussians ``mean_w`` ``f32[..., D]``, ``cov_w`` ``f32[..., D, D]``."""
    err = mean_w[..., None, :] - map_mean  # [..., K, D]
    total_cov = cov_w[..., None, :, :] + map_cov
    inv = inv_2x2(total_cov) if mean_w.shape[-1] == 2 else inv_3x3(total_cov)
    quad = torch.sum(torch.sum(err[..., :, None] * inv, dim=-2) * err, dim=-1)
    lik = d1 * torch.exp((-d2 / 2.0) * quad)
    return torch.sum(torch.where(found, lik, 0.0), dim=-1)


def probe_likelihood(keys: Tensor, values: Tensor, num_cells: int, resolution: float,
                     mean_w: Tensor, cov_w: Tensor, offsets, d1: float, d2: float,
                     probe=ndt_probe_reference) -> tuple[Tensor, Tensor]:
    """The stencil probe of query Gaussians ``mean_w`` ``f32[..., D]``,
    ``cov_w`` ``f32[..., D, D]``: their cells (``NdtMap.cell_near``), the
    keys of the cells at the host ``offsets`` ``[K, D]`` from them, those
    keys through ``probe`` (:func:`ndt_probe` or its plain version), and the
    stencil sum of :func:`stencil_likelihood`.  Returns ``(lik f32[...],
    found bool[..., K])``."""
    # the map owns the key format, and imports this module
    from beluga_tpu_torch.maps.ndt import encode_cells

    d = mean_w.shape[-1]
    res = torch.full((), resolution, dtype=torch.float32, device=mean_w.device)
    off = torch.as_tensor(np.asarray(offsets, np.int32), device=mean_w.device)
    center = torch.floor(mean_w / res).to(torch.int32)
    vals, found = probe(keys, values, num_cells, encode_cells(center[..., None, :] + off))
    lik = stencil_likelihood(mean_w, cov_w, vals[..., :d],
                             vals[..., d:].reshape(*found.shape, d, d), found, d1, d2)
    return lik, found


def particle_chunks(rot: Tensor, trans: Tensor, particle_chunk: int, body) -> Tensor:
    """``body(rot, trans) -> [..., ck]`` over chunks of ``particle_chunk``
    poses (``rot`` ``f32[..., N, D, D]``, ``trans`` ``f32[..., N, D]``),
    every filter at once, joined along the last axis; the per-(particle,
    cell, stencil) intermediates then stay within one chunk's size."""
    n = rot.shape[-3]
    ck = max(min(particle_chunk, n), 1)
    parts = [body(rot.narrow(-3, s, min(ck, n - s)), trans.narrow(-2, s, min(ck, n - s)))
             for s in range(0, n, ck)]
    if not parts:
        return torch.ones((*rot.shape[:-3], 0), dtype=torch.float32, device=rot.device)
    return torch.cat(parts, dim=-1)


def ndt_weights_reference(keys: Tensor, values: Tensor, num_cells: int, resolution: float,
                          rot: Tensor, trans: Tensor, meas_means: Tensor, meas_covs: Tensor,
                          cell_mask: Tensor, offsets, minimum_likelihood: float = 0.0,
                          d1: float = 1.0, d2: float = 1.0,
                          particle_chunk: int = 512) -> Tensor:
    """Plain PyTorch version of the fused kernel: the stencil probe
    (:func:`probe_likelihood` through B10's plain version) over chunks of
    ``particle_chunk`` particles."""
    def body(r: Tensor, t: Tensor) -> Tensor:
        mean_w, cov_w = world_gaussians(r, t, meas_means, meas_covs)
        lik, _ = probe_likelihood(keys, values, num_cells, resolution, mean_w, cov_w, offsets,
                                  d1, d2)
        lik = torch.clamp_min(lik, minimum_likelihood)
        return 1.0 + torch.sum(torch.where(cell_mask[..., None, :], lik, 0.0), dim=-1)

    return particle_chunks(rot, trans, particle_chunk, body)


def _check_weights(keys, values, num_cells, rot, trans, meas_means, meas_covs, cell_mask,
                   offsets) -> tuple:
    """The fleet's leading shape, particles, slots and dimension, after
    the checks of every input against the others."""
    device = keys.device
    for name, t in (("values", values), ("rot", rot), ("trans", trans),
                    ("meas_means", meas_means), ("meas_covs", meas_covs),
                    ("cell_mask", cell_mask)):
        if not isinstance(t, Tensor):
            raise ValueError(f"{name} must be a tensor")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, keys on {device}")
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise ValueError(f"keys must be int64[M], got {keys.dtype}{list(keys.shape)}")
    if rot.dtype != torch.float32 or rot.dim() < 3 or rot.shape[-1] not in (2, 3) \
            or rot.shape[-2] != rot.shape[-1]:
        raise ValueError(f"rot must be float32[..., N, D, D] with D 2 or 3, got "
                         f"{rot.dtype}{list(rot.shape)}")
    d, lead, n = rot.shape[-1], tuple(rot.shape[:-3]), rot.shape[-3]
    if values.dtype != torch.float32 or tuple(values.shape) != (keys.shape[0], d + d * d):
        raise ValueError(f"values must be float32[{keys.shape[0]}, {d + d * d}], got "
                         f"{values.dtype}{list(values.shape)}")
    if not 0 <= num_cells <= keys.shape[0]:
        raise ValueError(f"num_cells {num_cells} outside [0, {keys.shape[0]}]")
    if trans.dtype != torch.float32 or tuple(trans.shape) != (*lead, n, d):
        raise ValueError(f"trans must be float32{[*lead, n, d]}, got "
                         f"{trans.dtype}{list(trans.shape)}")
    c = meas_means.shape[-2] if meas_means.dim() >= 2 else -1
    mlead = tuple(meas_means.shape[:-2])
    want = {"meas_means": (meas_means, (*mlead, c, d), torch.float32),
            "meas_covs": (meas_covs, (*mlead, c, d, d), torch.float32),
            "cell_mask": (cell_mask, (*mlead, c), torch.bool)}
    for name, (t, shape, dtype) in want.items():
        if c < 0 or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype}{list(shape)}, got "
                             f"{t.dtype}{list(t.shape)}")
    try:
        broadcast = torch.broadcast_shapes(mlead, lead) == torch.Size(lead)
    except RuntimeError:
        broadcast = False
    if not broadcast:
        raise ValueError(f"the measurement cells' leading shape {list(mlead)} does not "
                         f"broadcast to the states' {list(lead)}")
    off = np.asarray(offsets)
    if off.dtype.kind not in "iu" or off.ndim != 2 or off.shape[1] != d \
            or not 0 < off.shape[0] <= MAX_OFFSETS:
        raise ValueError(f"offsets must be a host integer array [K, {d}] with "
                         f"0 < K <= {MAX_OFFSETS}, got {off.dtype}{list(off.shape)}")
    if c > MAX_SLOTS:
        raise ValueError(f"{c} measurement slots; the kernel takes at most {MAX_SLOTS}")
    if math.prod(lead) > MAX_FILTERS:
        raise ValueError(f"{math.prod(lead)} filters; the kernel takes at most {MAX_FILTERS}")
    return lead, n, c, d


def _check_index(index, device, d: int) -> None:
    """The cell index as the kernel takes it (``maps/ndt.py:CellIndex``)."""
    rows, lo, size = index.rows, tuple(index.lo), tuple(index.size)
    if not isinstance(rows, Tensor) or rows.device != device:
        raise ValueError(f"the cell index must be a tensor on {device}")
    if rows.dtype != torch.int16 or rows.dim() != 1 or not rows.is_contiguous() \
            or rows.numel() % 8 or not 0 < rows.numel() <= MAX_INDEX_CELLS:
        raise ValueError(f"the cell index's rows must be contiguous int16[E], E a multiple of "
                         f"8 in [8, {MAX_INDEX_CELLS}], got {rows.dtype}{list(rows.shape)}")
    width = 1 << (16 if d == 2 else 10)
    if len(lo) != d or len(size) != d or not all(0 <= v < width for v in lo) \
            or not all(0 <= v <= width for v in size) or math.prod(size) > rows.numel():
        raise ValueError(f"the cell index's box {lo}, {size} does not fit a {d}D key or its "
                         f"{rows.numel()} rows")


def ndt_weights(keys: Tensor, values: Tensor, num_cells: int, resolution: float, rot: Tensor,
                trans: Tensor, meas_means: Tensor, meas_covs: Tensor, cell_mask: Tensor,
                offsets, minimum_likelihood: float = 0.0, d1: float = 1.0, d2: float = 1.0,
                particle_chunk: int = 512, index=None) -> Tensor:
    """Each particle's NDT weight ``1 + Σ_live cells max(Σ_stencil
    found·d1·exp(-d2/2 · eᵀ(Σa + Σb)⁻¹e), minimum_likelihood)``,
    ``f32[..., N]``, in one launch on the card.

    Args:
      keys, values, num_cells, resolution: the map (``NdtMap``'s sorted
        int64 keys, its ``f32[M, D + D²]`` rows, live rows, cell size).
      rot, trans: the poses, ``f32[..., N, D, D]`` and ``f32[..., N, D]``.
      meas_means, meas_covs, cell_mask: the measurement cells, ``f32[...,
        C, D]``, ``f32[..., C, D, D]``, ``bool[..., C]``; their leading
        shape broadcasts to the poses'.
      offsets: the stencil, a host integer array ``[K, D]``.
      particle_chunk: the plain version's chunk; the kernel has none.
      index: the map's cell index (``NdtMap.index``), or None: the kernel
        then searches the sorted keys.  Either finds the same rows.
    """
    global weights_launches, weights_indexed_launches
    lead, n, c, d = _check_weights(keys, values, num_cells, rot, trans, meas_means, meas_covs,
                                   cell_mask, offsets)
    if index is not None:
        _check_index(index, keys.device, d)
    if not on_card(keys.device):
        return ndt_weights_reference(keys, values, num_cells, resolution, rot, trans,
                                     meas_means, meas_covs, cell_mask, offsets,
                                     minimum_likelihood, d1, d2, particle_chunk)
    filters = math.prod(lead)
    off = np.ascontiguousarray(np.asarray(offsets, np.int32))
    host_off = (ctypes.c_int * off.size)(*off.reshape(-1).tolist())
    means = meas_means.expand(*lead, c, d).contiguous()
    covs = meas_covs.expand(*lead, c, d, d).contiguous()
    mask = cell_mask.expand(*lead, c).contiguous()
    k32 = keys.to(torch.int32)  # the low 32 bits, read as uint32_t
    vals, r, t = values.contiguous(), rot.contiguous(), trans.contiguous()
    if vals.data_ptr() % 16:  # the kernel reads a row 8 (2D) or 16 (3D) bytes at a time
        vals = vals.clone()
    out = torch.empty((*lead, n), dtype=torch.float32, device=keys.device)
    stream = stream_ptr(keys.device)
    if index is None:
        rows, cells, box = None, 0, None
    else:
        rows, cells = index.rows.data_ptr(), index.rows.numel()
        box = (ctypes.c_uint * (2 * d))(*index.lo, *index.size)
    _weights(k32.data_ptr(), num_cells, rows, cells, box, vals.data_ptr(), r.data_ptr(),
             t.data_ptr(), means.data_ptr(), covs.data_ptr(), mask.data_ptr(), filters, n, c, d,
             host_off, off.shape[0], float(resolution), float(minimum_likelihood), float(d1),
             -float(d2) / 2.0, out.data_ptr(), stream)
    weights_launches += 1
    weights_indexed_launches += index is not None
    return out
