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
    """

    keys: Tensor
    means: Tensor
    covs: Tensor
    values: Tensor
    num_cells: int
    resolution: float

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
                                   covs=self.covs.to(device), values=self.values.to(device))


def make_ndt_map(cells, means, covs, resolution: float, device=None) -> NdtMap:
    """The sorted table from host arrays (cells ``[C, D]``, means
    ``[C, D]``, covariances ``[C, D, D]``), on ``device`` (default the
    card).  An empty map keeps one sentinel row so that lookups stay
    well-formed."""
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
                  num_cells=int(n), resolution=float(np.float32(resolution)))


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
