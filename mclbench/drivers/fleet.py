"""Driver of a fleet of AMCL filters: ``beluga_tpu_torch``'s fleet update
over ``[robots, particles]`` states, one call a tick.

The configuration file names the sensor model and its parameters, and the
sensor's own module (``mclbench/sensors/<sensor>.py``) builds the port's
model table for it; everything else is the filter of ``AmclParams`` and
the differential-drive motion model.  The program is built through the
port's public entry points only: the sensor's, ``init_fleet_state`` and
``make_fleet_update``.

The model table is wrapped: with ``ranges`` each model function runs
inside a profiler range ``models.<name>`` (the spans the per-layer metrics
read), and on a tick armed by :meth:`Fleet.arm` the wrapper keeps copies
of what the model functions took and gave for the sampled robots (the
inputs of the correctness check).  The copies are small and made on the
device; the whole fleet's output particles go to pinned host buffers made
at set-up, so that the check adds nothing to the device's peak memory.
"""

from __future__ import annotations

import contextlib
import importlib

import numpy as np
import torch


class Fleet:
    """``robots`` filters of ``particles`` each, every one started from a
    normal cloud of the configuration's covariance about its robot's first
    pose ``start`` (``f64[robots, 3]``), drawn from ``seed``."""

    def __init__(self, config: dict, data: np.ndarray, start: np.ndarray, device, seed: int,
                 robots: int, particles: int):
        import beluga_tpu_torch as bt
        from beluga_tpu_torch.filters.amcl import init_fleet_state
        from beluga_tpu_torch.models.motion.differential_drive import DifferentialDriveParams

        self.device = torch.device(device)
        f = config["filter"]
        self.params = bt.AmclParams(
            update_min_d=f["update_min_d"], update_min_a=f["update_min_a"],
            min_particles=particles, max_particles=particles, alpha_slow=f["alpha_slow"],
            alpha_fast=f["alpha_fast"], resampling=f["resampling"],
            sorted_slots=f["sorted_slots"])
        sensor = importlib.import_module(f"mclbench.sensors.{config['sensor']}")
        models, self.ctx = sensor.build(config, data,
                                        DifferentialDriveParams(*config["motion_alphas"]),
                                        self.device)
        self.ranges = False
        self._armed = None  # (rows, record) on an armed tick
        self.models = models._replace(**{
            name: self._wrap(name, getattr(models, name))
            for name in ("propagate", "log_weight", "random_state", "hash_state", "estimate")})
        self.update = bt.make_fleet_update(self.params, self.models)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        mean = bt.SE2.from_xytheta(*(torch.as_tensor(start[:, i], dtype=torch.float32)
                                     for i in range(3)), device=self.device)
        self.state = init_fleet_state(gen, robots, mean, np.diag(config["initial_cov"]),
                                      self.params, device=self.device)
        self._buffers: list = []

    def reserve(self) -> None:
        """Host buffers for the whole fleet's output particles on one armed
        tick (pinned on the card, so that their copy runs asynchronously),
        made now so that the window makes none."""
        p = self.state.particles
        pin = self.device.type == "cuda"
        self._buffers = [[torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                          for t in (p.state.xy, p.state.rot.z, p.log_weight)]]

    # -- the model table ---------------------------------------------------------------

    def _wrap(self, name: str, fn):
        def inner(*args):
            with self._range(f"models.{name}"):
                out = fn(*args)
            if self._armed is not None:
                self._keep(name, args, out)
            return out

        return inner

    def _keep(self, name: str, args, out) -> None:
        rows, rec = self._armed
        if name == "propagate":
            rec["z"] = args[1][rows].clone()
            rec["prop_xy"], rec["prop_rot"] = _se2_rows(out, rows)
        elif name == "log_weight":
            rec["loglik"] = out[rows].clone()
        elif name == "random_state":
            rec["pool_xy"], rec["pool_rot"] = _se2_rows(out, rows)

    # -- one tick ------------------------------------------------------------------------

    def arm(self, rows: torch.Tensor, whole: bool) -> dict:
        """Keep, on the next :meth:`step`, the inputs and outputs of each
        stage for the robots ``rows``, and with ``whole`` the whole fleet's
        output particles; returns the record the step fills."""
        p = self.state.particles
        rec = {"rows": rows, "whole": whole}
        rec["in_xy"], rec["in_rot"] = _se2_rows(p.state, rows)
        rec["in_logw"] = p.log_weight[rows].clone()
        th = self.state.thrun
        rec["in_thrun"] = torch.stack([th.slow.value[rows], th.slow.seeded[rows].float(),
                                       th.fast.value[rows], th.fast.seeded[rows].float()], -1)
        self._armed = (rows, rec)
        return rec

    def step(self, odom: torch.Tensor, points: torch.Tensor, masks: torch.Tensor):
        """The fleet update on this tick's inputs (odometry ``f32[B, 3]`` on
        the host, as a robot sends it; scans on the card), then the
        estimates read back: ``(f64[B, 3] poses, bool[B] valid)``."""
        from beluga_tpu_torch import SE2

        odom = SE2.from_xytheta(odom[:, 0], odom[:, 1], odom[:, 2], device="cpu")
        with self._range("fleet.update"):
            self.state, est = self.update(self.ctx, self.state, odom, points, masks)
        if self._armed is not None:
            rows, rec = self._armed
            self._armed = None
            p = self.state.particles
            rec["out_xy"], rec["out_rot"] = _se2_rows(p.state, rows)
            if rec["whole"]:
                out = self._buffers.pop()
                for dst, src in zip(out, (p.state.xy, p.state.rot.z, p.log_weight)):
                    dst.copy_(src, non_blocking=True)
                rec["all_xy"], rec["all_rot"], rec["all_logw"] = out
        with self._range("tick.readback"):
            pose = est.pose.as_xytheta().cpu().numpy().astype(np.float64)
        return pose, np.asarray(est.valid)

    def _range(self, label: str):
        from torch.profiler import record_function

        return record_function(label) if self.ranges else contextlib.nullcontext()

    def close(self) -> None:
        """Let go of the program's state, map and kernels' inputs."""
        self.state = self.ctx = self.models = self.update = None


def _se2_rows(states, rows):
    return states.xy[rows].clone(), states.rot.z[rows].clone()
