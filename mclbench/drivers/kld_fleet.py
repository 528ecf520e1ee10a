"""Driver of a fleet of KLD-adaptive AMCL filters: ``drivers/fleet.py``'s
fleet, with ``min_particles`` below ``max_particles`` (the slot capacity,
the configuration's ``particles``), so that every resample ends in the KLD
count of each filter's live particles (``filters/amcl.py:inject_and_count``),
after Thrun's injection has drawn a recovery state for every slot (taken
where the filter's random-state probability is above 0).

The configuration states ``min_particles``, ``kld_epsilon``, ``kld_z``
and the spatial bins of the count (``spatial_resolution_x``,
``spatial_resolution_y``, ``spatial_resolution_theta_deg``); everything
else is :class:`drivers.fleet.Fleet`'s.  Where the tests shrink
``particles``, ``min_particles`` is capped at a quarter of it.

On an armed tick the record also keeps, for the sampled robots, the KLD
stage's input (the candidates in draw order, the model's ``hash_state``
input) and output (their hashes), the live counts before and after the
update and the output log-weights; with ``whole``, every robot's live
count.  On a traced tick, once the estimates are on the host, the fleet's
live total is marked in the trace as the program's counter ``kld.live``
(``utils/profiling.py:count``); an untraced tick makes no copy for it.
"""

from __future__ import annotations

import dataclasses
import math

from mclbench.drivers import fleet


def _counter():
    """The program's counter, or None in a program without one."""
    try:
        from beluga_tpu_torch.utils.profiling import count
    except ImportError:
        return None
    return count


class Fleet(fleet.Fleet):
    def __init__(self, config: dict, data, start, device, seed: int, robots: int,
                 particles: int):
        super().__init__(config, data, start, device, seed, robots, particles)
        import beluga_tpu_torch as bt

        k = config["kld"]
        self.params = dataclasses.replace(
            self.params, min_particles=min(k["min_particles"], particles // 4),
            kld_epsilon=k["kld_epsilon"], kld_z=k["kld_z"],
            spatial_resolution_x=k["spatial_resolution_x"],
            spatial_resolution_y=k["spatial_resolution_y"],
            spatial_resolution_theta=math.radians(k["spatial_resolution_theta_deg"]),
            recovery_pool=config["filter"]["recovery_pool"])
        self.update = bt.make_fleet_update(self.params, self.models)
        self._count = _counter()

    def _keep(self, name: str, args, out) -> None:
        super()._keep(name, args, out)
        if name == "hash_state":
            rows, rec = self._armed
            rec["cand_xy"], rec["cand_rot"] = fleet._se2_rows(args[1], rows)
            rec["hashes"] = out[rows].clone()

    def arm(self, rows, whole: bool) -> dict:
        rec = super().arm(rows, whole)
        rec["in_active"] = self.state.particles.active[rows].clone()
        return rec

    def step(self, odom, points, masks):
        armed = self._armed
        pose, valid = super().step(odom, points, masks)
        p = self.state.particles
        if armed is not None:
            rows, rec = armed
            rec["out_active"] = p.active[rows].clone()
            rec["out_logw"] = p.log_weight[rows].clone()
            if rec["whole"]:
                rec["all_active"] = p.active.clone()
        if self.ranges and self._count is not None:
            # the queue drained at the readback: one small copy, no kernel
            self._count("kld.live", int(p.active.cpu().sum()))
        return pose, valid
