"""Accuracy metrics (port of ``beluga_tpu/utils/metrics.py``; the evo_ape
and beluga_benchmark analysis analog).

The reference measures accuracy offline with ``evo_ape`` against the bag's
ground truth (beluga_benchmark/docs/BENCHMARKING.md) and compares runs with
``compare_results.py``.  These are the same quantities as plain functions
over pose arrays, in numpy.
"""

from __future__ import annotations

import numpy as np


def _wrap_angle(a):
    return np.arctan2(np.sin(a), np.cos(a))


def ape(estimates_xyt: np.ndarray, ground_truth_xyt: np.ndarray) -> dict:
    """Absolute pose error between (x, y, yaw) trajectories: translation
    RMSE, mean, median and max (meters), yaw RMSE and max (radians), and
    the count."""
    est = np.asarray(estimates_xyt, np.float64)
    gt = np.asarray(ground_truth_xyt, np.float64)
    if est.shape != gt.shape or est.shape[-1] != 3:
        raise ValueError(f"need two [T, 3] trajectories, got {est.shape} and {gt.shape}")
    terr = np.linalg.norm(est[:, :2] - gt[:, :2], axis=-1)
    yerr = np.abs(_wrap_angle(est[:, 2] - gt[:, 2]))
    return {
        "rmse": float(np.sqrt(np.mean(terr**2))),
        "mean": float(np.mean(terr)),
        "median": float(np.median(terr)),
        "max": float(np.max(terr)),
        "yaw_rmse": float(np.sqrt(np.mean(yerr**2))),
        "yaw_max": float(np.max(yerr)),
        "count": int(len(terr)),
    }


def compare_runs(runs: dict[str, dict]) -> str:
    """A table of APE summaries from several runs (compare_results.py analog)."""
    cols = ["rmse", "mean", "max", "yaw_rmse", "count"]
    lines = ["run".ljust(28) + "  ".join(c.rjust(9) for c in cols)]
    for name, m in runs.items():
        lines.append(name.ljust(28) + "  ".join(
            (f"{m[c]:9.4f}" if isinstance(m[c], float) else f"{m[c]:9d}") for c in cols))
    return "\n".join(lines)
