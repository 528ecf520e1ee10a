"""The one traffic generator: it reads a mix's parameters
(``mclbench/traffic/<mix>.json``) and yields, tick by tick, where every
robot of the fleet is.

Every robot drives the arena's circle on the lattice of ``lattice`` poses
(``world.lattice_poses``): a tick that it drives moves it ``step`` lattice
points on, a tick that it stands leaves it where it is.  Robot ``b`` starts at
lattice point ``start + b``, ``start`` drawn from the seed, so that no two
robots share a pose or a scan, and every seed gives the fleet the same set
of poses and scans in another order.  While every robot drives, each
tick's scans are one run of consecutive lattice points.

A mix with ``drive_mean_ticks`` and ``stand_mean_ticks`` set alternates
each robot between runs of driving and of standing, each run's length
geometric with that mean and drawn from the seed, and each robot's first
run driving or standing with the odds of the two means.  Without them
every robot drives at every tick.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


class Tick(NamedTuple):
    """One tick of the fleet: each robot's lattice point ``idx``, whether
    it drove this tick (``moved``; every robot at the first tick), and
    ``prev_idx``, its lattice point at the last tick it drove before this
    one (its own ``idx`` at the first tick)."""

    t: int
    idx: np.ndarray  # int64[B]
    moved: np.ndarray  # bool[B]
    prev_idx: np.ndarray  # int64[B]


def load_mix(name: str) -> dict:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


class Ticks:
    """The ticks of one run: ``next()`` gives tick 0, 1, 2, ... of
    ``robots`` robots under ``mix``, the same for the same ``seed``."""

    def __init__(self, mix: dict, robots: int, seed: int):
        self.lattice, self.step = int(mix["lattice"]), int(mix["step"])
        if robots > self.lattice:
            raise ValueError(f"{robots} robots on a lattice of {self.lattice} poses")
        self.rng = np.random.default_rng(seed)
        self.robots = robots
        start = int(self.rng.integers(self.lattice))
        self.idx = (start + np.arange(robots, dtype=np.int64)) % self.lattice
        self.last_due = self.idx.copy()
        drive, stand = mix.get("drive_mean_ticks"), mix.get("stand_mean_ticks")
        self.alternating = bool(drive and stand)
        if self.alternating:
            self.means = (float(stand), float(drive))  # by the run's state: 0 stands, 1 drives
            self.driving = self.rng.random(robots) < drive / (drive + stand)
            self.left = self._run_lengths(self.driving)
        self.t = -1

    def _run_lengths(self, driving: np.ndarray) -> np.ndarray:
        mean = np.where(driving, self.means[1], self.means[0])
        return self.rng.geometric(1.0 / mean).astype(np.int64)

    def next(self) -> Tick:
        self.t += 1
        if self.t == 0:
            return Tick(0, self.idx.copy(), np.ones(self.robots, bool), self.idx.copy())
        if self.alternating:
            self.left -= 1
            flip = self.left == 0
            if flip.any():
                self.driving[flip] = ~self.driving[flip]
                self.left[flip] = self._run_lengths(self.driving[flip])
            moved = self.driving.copy()
        else:
            moved = np.ones(self.robots, bool)
        self.idx = np.where(moved, (self.idx + self.step) % self.lattice, self.idx)
        prev = self.last_due.copy()
        self.last_due = np.where(moved, self.idx, self.last_due)
        return Tick(self.t, self.idx.copy(), moved, prev)
