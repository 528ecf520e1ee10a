"""The sensor models a configuration can name (its ``"sensor"`` key), one
module each, found by that name: ``mclbench/sensors/<sensor>.py``.

Each module has two functions:

* ``build(config, data, motion, device)``: the port's filter for the
  configuration, ``(models, ctx)``, through the port's public entry points;
* ``work(config, data, points, mask, poses, particles)``: the operations
  and bytes the sensor's weights need, as a function of one tick's robots
  (their lattice points ``idx``) that returns ``(operations, bytes)``;
  ``points``, ``mask`` are the lattice's scans and ``poses`` its poses.
  The counts are the least the work needs, each input byte read once and
  each output byte written once (``mclbench/roofline.py``).

A configuration on another sensor model adds its module here, and the
harness finds it by name.
"""
