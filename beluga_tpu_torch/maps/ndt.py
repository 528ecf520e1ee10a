"""Sparse NDT voxel maps as sorted dense tables (port of
``beluga_tpu/maps/ndt.py``).

The reference stores an NDT map as a hash map from cell to Gaussian
(sensor/data/sparse_value_grid.hpp); here it is a table sorted by encoded
cell key, so that a lookup is a search of the sorted keys.  Cell
coordinates pack into one unsigned 32-bit key:

* 2D: 16 bits per axis, biased by 2^15 (cells in [-32768, 32767]);
* 3D: 10 bits per axis, biased by 2^9 (cells in [-512, 511]).

Keys are held in int64 tensors in ``[0, 2^32)``: PyTorch's ``uint32`` has
few operators, and a 2D key with x >= 0 is >= 2^31, so a signed 32-bit
compare would misorder them.  :meth:`NdtMap.lookup_gaussians` probes the
table through kernel B10 (``ops/cuda_ndt.py``) on the card and through its
plain version on the CPU; both give the map's float32 values exactly.

Beside the sorted table, a map whose live keys fit a small box keeps a
dense cell → row index over that box (:class:`CellIndex`), built once on
the host with the map: the fused NDT kernel (``ops/cuda_ndt.py:
ndt_weights``) then finds a probe's row with one load instead of a binary
search.  The box lies in the key's own wrapped coordinates, so a probe
finds a row through the index exactly when its key equals a live key.

Includes the HDF5 loader of the reference's layout
(``sensor/ndt_sensor_model.hpp:246-320``: "resolution", "cells", "means",
"covariances").
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from beluga_tpu_torch import resolve_device
from beluga_tpu_torch.ops.cuda_ndt import ndt_probe

Tensor = torch.Tensor

BIAS2, BITS2 = 1 << 15, 16
BIAS3, BITS3 = 1 << 9, 10
_MASK32 = 0xFFFFFFFF
# the cell index's budget: its int16 rows take at most 64 KB of the fused
# kernel's shared memory; a map whose box holds more cells has no index
INDEX_MAX_CELLS = 1 << 15
NO_ROW = -1
# cells of NO_ROW the box keeps on each side of the live keys, where the
# budget allows: the reach of the standard stencils, so that the fused
# kernel finds every probe of a cell at the map's edge inside the box
INDEX_PAD = 1


def encode_cells(cells: Tensor) -> Tensor:
    """Pack integer cell coordinates ``[..., D]`` into int64 keys ``[...]``
    in ``[0, 2^32)``, with the reference's uint32 wrap-around."""
    c = cells.to(torch.int64)
    d = c.shape[-1]
    if d == 2:
        x = ((c[..., 0] + BIAS2) << BITS2) & _MASK32
        return x | ((c[..., 1] + BIAS2) & ((1 << BITS2) - 1))
    if d == 3:
        m = (1 << BITS3) - 1
        return ((((c[..., 0] + BIAS3) & m) << (2 * BITS3)) | (((c[..., 1] + BIAS3) & m) << BITS3)
                | ((c[..., 2] + BIAS3) & m))
    raise ValueError(f"unsupported dimension {d}")


def decode_keys(keys: Tensor, d: int) -> Tensor:
    """The int32 cell coordinates ``[..., D]`` of int64 keys."""
    if d == 2:
        cells = [(keys >> BITS2) - BIAS2, (keys & ((1 << BITS2) - 1)) - BIAS2]
    else:
        m = (1 << BITS3) - 1
        cells = [((keys >> (2 * BITS3)) & m) - BIAS3, ((keys >> BITS3) & m) - BIAS3,
                 (keys & m) - BIAS3]
    return torch.stack(cells, dim=-1).to(torch.int32)


def _axis_bits(d: int) -> int:
    return BITS2 if d == 2 else BITS3


def _cyclic_span(values: np.ndarray, period: int) -> tuple[int, int]:
    """``(lo, size)`` of the shortest run ``lo, lo + 1, ... (mod period)``
    that holds every one of ``values``: the complement of the widest gap
    between neighbours on the circle."""
    v = np.unique(values)
    gaps = np.append(np.diff(v), v[0] + period - v[-1])
    widest = int(np.argmax(gaps[::-1]))  # ties: the last, the wrap gap first
    widest = len(v) - 1 - widest
    lo = int(v[(widest + 1) % len(v)])
    return lo, period - int(gaps[widest]) + 1


@dataclasses.dataclass(frozen=True)
class CellIndex:
    """A dense cell → row index over the box of a map's live keys.

    The box lies in the key's own coordinates, the low bits of ``cell +
    bias`` on each axis (16 in 2D, 10 in 3D), which is all of a cell that
    its key holds.  On axis ``a`` it holds the
    coordinates ``u`` with ``(u - lo[a]) mod 2^bits < size[a]``, so a box
    may run across the wrap; the cell at box offsets ``(o0, o1[, o2])``
    lies at ``(o0·size1 + o1)·size2 + o2`` of ``rows``.  Each entry is the
    row that ``searchsorted`` finds for that key (the first live row that
    holds it) or ``NO_ROW``.

    Attributes:
      rows: ``int16[E]``, ``E`` the box's cells rounded up to a multiple
        of 8 (the kernel stages it 16 bytes at a time), the padding
        ``NO_ROW``.
      lo, size: the box, one host int an axis.
    """

    rows: Tensor
    lo: tuple[int, ...]
    size: tuple[int, ...]

    def lookup(self, cells: Tensor) -> Tensor:
        """Cell coordinates ``[..., D]`` → row ``int64[...]``, or ``NO_ROW``
        (outside the box, or no live key there): the kernel's address
        arithmetic, in plain PyTorch."""
        d = len(self.size)
        mask = (1 << _axis_bits(d)) - 1
        bias = BIAS2 if d == 2 else BIAS3
        c = cells.to(torch.int64)
        inside = torch.ones(c.shape[:-1], dtype=torch.bool, device=c.device)
        flat = torch.zeros(c.shape[:-1], dtype=torch.int64, device=c.device)
        for a in range(d):
            off = (c[..., a] + bias - self.lo[a]) & mask
            inside &= off < self.size[a]
            flat = flat * self.size[a] + off
        rows = self.rows.to(c.device).to(torch.int64)
        got = rows[torch.where(inside, flat, 0)]
        return torch.where(inside, got, NO_ROW)

    def to(self, device) -> "CellIndex":
        return dataclasses.replace(self, rows=self.rows.to(device))


def cell_index(keys, num_cells: int, d: int, device=None) -> CellIndex | None:
    """The :class:`CellIndex` of a map's sorted host keys ``int64[M]``
    (``keys[:num_cells]`` live) in ``d`` dimensions, on ``device``: the
    live keys' box widened by ``INDEX_PAD`` on each side where that fits
    ``INDEX_MAX_CELLS``; None where the box alone does not, so that the
    map alone decides whether the fused kernel probes by address."""
    live = np.asarray(keys, np.int64)[:num_cells]
    if num_cells > INDEX_MAX_CELLS:  # rows past int16
        return None
    if live.size == 0:
        lo, size = (0,) * d, (0,) * d
        flat = np.zeros(0, np.int64)
    else:
        period = 1 << _axis_bits(d)
        u = decode_keys(torch.from_numpy(live), d).numpy().astype(np.int64) + period // 2
        lo, size = zip(*(_cyclic_span(u[:, a], period) for a in range(d)))
        padded = [min(v + 2 * INDEX_PAD, period) for v in size]
        if int(np.prod(padded)) <= INDEX_MAX_CELLS:
            lo, size = [(v - INDEX_PAD) % period for v in lo], padded
        elif int(np.prod(size)) > INDEX_MAX_CELLS:
            return None
        flat = np.zeros(len(live), np.int64)
        for a in range(d):
            flat = flat * size[a] + ((u[:, a] - lo[a]) % period)
    cells = int(np.prod(size))
    rows = np.full(max(-(-cells // 8) * 8, 8), NO_ROW, np.int16)
    first, at = np.unique(flat, return_index=True)  # searchsorted finds the first
    rows[first] = at
    return CellIndex(rows=torch.from_numpy(rows).to(resolve_device(device)),
                     lo=tuple(int(v) for v in lo), size=tuple(int(v) for v in size))


@dataclasses.dataclass(frozen=True)
class NdtMap:
    """Sorted NDT cell table on one device.

    Attributes:
      keys: int64 ``[M]`` sorted encoded cell keys; rows past ``num_cells``
        (the empty map's one sentinel row) hold 0xFFFFFFFF.
      means: ``f32[M, D]`` Gaussian means (world units).
      covs: ``f32[M, D, D]`` Gaussian covariances.
      values: ``f32[M, D + D²]`` each row's mean and flattened covariance,
        the table kernel B10 reads.
      num_cells: the number of live rows.
      resolution: the cell size (meters).
      index: the dense cell → row index of the live keys' box, or None
        where the box is too large for it (``cell_index``).
    """

    keys: Tensor
    means: Tensor
    covs: Tensor
    values: Tensor
    num_cells: int
    resolution: float
    index: CellIndex | None = None

    @property
    def dim(self) -> int:
        return self.means.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.keys.device

    def lookup(self, cells: Tensor) -> tuple[Tensor, Tensor]:
        """Cell coordinates ``[..., D]`` → (row ``int64[...]``, found
        ``bool[...]``); a query that is not found gives row 0."""
        q = encode_cells(cells)
        idx = torch.clamp(torch.searchsorted(self.keys, q), 0, self.keys.shape[0] - 1)
        found = (self.keys[idx] == q) & (idx < self.num_cells)
        return torch.where(found, idx, 0), found

    def cell_near(self, points: Tensor) -> Tensor:
        """``floor(p / resolution)`` as int32 (regular_grid.hpp:76-80); the
        division is by a tensor, as in float32 JAX (PyTorch's CUDA division
        by a Python number multiplies by its reciprocal)."""
        res = torch.full((), self.resolution, dtype=torch.float32, device=points.device)
        return torch.floor(points / res).to(torch.int32)

    def lookup_gaussians(self, cells: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        """Cell coordinates ``[..., D]`` → (means ``[..., D]``, covariances
        ``[..., D, D]``, found ``bool[...]``) through kernel B10; a query
        that is not found takes cell 0's Gaussian, as ``lookup`` gives row 0
        (maps/ndt.py:136-140), and callers mask by ``found``."""
        d = self.dim
        vals, found = ndt_probe(self.keys, self.values, self.num_cells, encode_cells(cells))
        means = torch.where(found[..., None], vals[..., :d], self.means[0])
        covs = torch.where(found[..., None, None], vals[..., d:].reshape(*found.shape, d, d),
                           self.covs[0])
        return means, covs, found

    def to(self, device) -> "NdtMap":
        return dataclasses.replace(self, keys=self.keys.to(device), means=self.means.to(device),
                                   covs=self.covs.to(device), values=self.values.to(device),
                                   index=None if self.index is None else self.index.to(device))


def make_ndt_map(cells, means, covs, resolution: float, device=None) -> NdtMap:
    """The sorted table from host arrays (cells ``[C, D]``, means
    ``[C, D]``, covariances ``[C, D, D]``), on ``device`` (default the
    card), with its cell index where the live keys' box fits one.  An
    empty map keeps one sentinel row so that lookups stay well-formed."""
    device = resolve_device(device)
    cells = np.asarray(cells, np.int32)
    means = np.asarray(means, np.float32)
    covs = np.asarray(covs, np.float32)
    n, d = cells.shape
    d = d or 2
    if n == 0:
        keys = np.full(1, _MASK32, np.int64)
        means = np.zeros((1, d), np.float32)
        covs = np.eye(d, dtype=np.float32)[None]
    else:
        keys = encode_cells(torch.from_numpy(cells)).numpy()  # on the host
        order = np.argsort(keys, kind="stable")
        keys, means, covs = keys[order], means[order], covs[order]
    values = np.concatenate([means, covs.reshape(len(keys), d * d)], axis=1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return NdtMap(keys=t(keys), means=t(means), covs=t(covs), values=t(values),
                  num_cells=int(n), resolution=float(np.float32(resolution)),
                  index=cell_index(keys, int(n), d, device))


def load_ndt_hdf5(path: str, device=None) -> NdtMap:
    """Load an NDT map of the reference's HDF5 layout
    (ndt_sensor_model.hpp:246-320)."""
    import h5py

    with h5py.File(path, "r") as f:
        resolution = float(np.asarray(f["resolution"]))
        cells = np.asarray(f["cells"])
        means = np.asarray(f["means"])
        covs = np.asarray(f["covariances"])
    return make_ndt_map(cells, means, covs, resolution, device)
