"""Stationary motion model: Gaussian jitter about the current state (port
of ``beluga_tpu/models/motion/stationary.py``).

``motion/stationary_model.hpp:39-60`` ignores the control action and
right-multiplies each state by ``SE2(N(0, 0.02), (N(0, 0.02), N(0,
0.02)))``: a jitter in the body frame.  The standard normals ``z[..., 3,
N]`` come in as an input, the same draws as diff-drive takes.
"""

from __future__ import annotations

import torch

from beluga_tpu_torch.lie import SE2, SO2

Tensor = torch.Tensor

_SIGMA = 0.02


def stationary_propagate(z: Tensor, states: SE2) -> SE2:
    """``states * SE2(0.02 z0, 0.02 (z1, z2))`` per particle, ``z``
    f32[..., 3, N]."""
    d = z * _SIGMA
    new_xy = states.xy + states.rot.act(torch.stack([d[..., 1, :], d[..., 2, :]], dim=-1))
    return SE2(new_xy, SO2.exp(states.theta + d[..., 0, :]))
