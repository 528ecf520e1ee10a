"""NDT map conversion (port of ``beluga_tpu/tools/make_ndt_map.py``, a
numpy copy: the ``attic/beluga_tools`` equivalent).

Converts an occupancy-grid map (PGM + YAML) or a PLY point cloud into the
HDF5 NDT map layout that ``maps/ndt.py:load_ndt_hdf5`` reads (datasets
"resolution" / "cells" / "means" / "covariances",
``sensor/ndt_sensor_model.hpp:246-320``).  Occupied cells become
cell-centre points in the map frame, points are clustered into
``cell_size`` voxels, and a Gaussian is fit to each cluster of at least
``min_points`` points with a variance floor on the diagonal
(conversion_utils.py:fit_normal_distribution, min_variance 5e-3).  The
port's tests and workloads build their NDT maps from the synthetic arena
with these functions.

Usage:
  python -m beluga_tpu_torch.tools.make_ndt_map --map map.yaml --output map.hdf5
  python -m beluga_tpu_torch.tools.make_ndt_map --ply cloud.ply --output map.hdf5
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def grid_to_points(data: np.ndarray, resolution: float,
                   origin=(0.0, 0.0)) -> np.ndarray:
    """Occupied cells → cell-center 2D points in the map frame, f64[N, 2].

    ``data`` uses the framework's trinary convention (occupied = 100,
    row 0 = bottom; maps/occupancy.py).
    """
    yy, xx = np.nonzero(data == 100)
    pts = np.stack([xx, yy], -1).astype(np.float64)
    return pts * resolution + resolution / 2.0 + np.asarray(origin, np.float64)


def fit_ndt_cells(points: np.ndarray, cell_size: float,
                  min_points: int = 6, min_variance: float = 5e-3):
    """Cluster points into voxels and fit per-voxel Gaussians.

    Returns (cells i64[C, D], means f64[C, D], covs f64[C, D, D]).
    Clusters with fewer than ``min_points`` points are dropped
    (conversion_utils.py:fit_normal_distribution — Magnusson 2009 §6).
    """
    d = points.shape[1]
    keys = np.floor(points / cell_size).astype(np.int64)
    uniq, inv, counts = np.unique(
        keys, axis=0, return_inverse=True, return_counts=True
    )
    cells, means, covs = [], [], []
    order = np.argsort(inv, kind="stable")
    bounds = np.concatenate([[0], np.cumsum(counts)])
    for c in range(len(uniq)):
        if counts[c] < min_points:
            continue
        pts = points[order[bounds[c] : bounds[c + 1]]]
        cov = np.cov(pts.T)
        for k in range(d):
            cov[k, k] = max(cov[k, k], min_variance)
        cells.append(uniq[c])
        means.append(pts.mean(axis=0))
        covs.append(cov)
    if not cells:
        return (np.zeros((0, d), np.int64), np.zeros((0, d)),
                np.zeros((0, d, d)))
    return np.asarray(cells), np.asarray(means), np.asarray(covs)


def save_ndt_hdf5(path, cells, means, covs, resolution: float) -> None:
    """Write the reference HDF5 layout (ndt_sensor_model.hpp:246-320)."""
    import h5py

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as f:
        f.create_dataset("cells", data=np.asarray(cells), chunks=True)
        f.create_dataset("means", data=np.asarray(means), chunks=True)
        f.create_dataset("covariances", data=np.asarray(covs))
        f.create_dataset("resolution", data=np.asarray(resolution))


def load_ply_points(path) -> np.ndarray:
    """Minimal PLY reader (ascii and binary_little_endian): x/y/z floats.

    Covers the files beluga_tools' ply_to_ndt handled via plyfile.
    """
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a PLY file")
        fmt = None
        count = 0
        props = []
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unterminated PLY header")
            parts = line.decode("ascii", "replace").split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    count = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                props.append((parts[-1], parts[1]))
            elif parts[0] == "end_header":
                break
        type_map = {"float": "f4", "float32": "f4", "double": "f8",
                    "float64": "f8", "uchar": "u1", "uint8": "u1",
                    "int": "i4", "int32": "i4", "uint": "u4", "short": "i2",
                    "ushort": "u2", "char": "i1"}
        names = [n for n, _ in props]
        if fmt == "ascii":
            rows = np.loadtxt(f, max_rows=count, ndmin=2)
            data = {n: rows[:, i] for i, (n, _) in enumerate(props)}
        elif fmt == "binary_little_endian":
            dtype = np.dtype([(n, "<" + type_map[t]) for n, t in props])
            raw = np.frombuffer(f.read(count * dtype.itemsize), dtype,
                                count=count)
            data = {n: raw[n] for n in names}
        else:
            raise ValueError(f"unsupported PLY format: {fmt}")
        for k in ("x", "y", "z"):
            if k not in data:
                raise ValueError(f"PLY has no '{k}' vertex property")
        return np.stack([np.asarray(data["x"], np.float64),
                         np.asarray(data["y"], np.float64),
                         np.asarray(data["z"], np.float64)], -1)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--map", help="occupancy map YAML (PGM + metadata) -> 2D NDT")
    src.add_argument("--ply", help="PLY point cloud -> 3D NDT")
    p.add_argument("--output", required=True, help="output .hdf5 path")
    p.add_argument("--cell-size", type=float, default=1.0,
                   help="NDT voxel edge in meters (beluga_tools default)")
    p.add_argument("--min-points", type=int, default=6)
    p.add_argument("--min-variance", type=float, default=5e-3)
    args = p.parse_args(argv)

    if args.map:
        from beluga_tpu_torch.maps.occupancy import load_pgm_yaml

        grid = load_pgm_yaml(args.map, device="cpu")  # host-side conversion
        ox, oy, _ = grid.origin_xytheta
        points = grid_to_points(grid.data.numpy(), grid.resolution, (ox, oy))
    else:
        points = load_ply_points(args.ply)

    cells, means, covs = fit_ndt_cells(points, args.cell_size, args.min_points,
                                       args.min_variance)
    save_ndt_hdf5(args.output, cells, means, covs, args.cell_size)
    print(f"wrote {len(cells)} NDT cells ({points.shape[1]}D) to {args.output}")


if __name__ == "__main__":
    main()
