"""Thrun adaptive-recovery probability (port of
``beluga_tpu/algorithms/thrun.py``, Probabilistic Robotics 8.3.3).

Slow and fast exponential filters (exponential_filter.hpp:26-50) over the
post-normalize average weight, ``p = clamp(1 - fast / slow, 0, 1)``
(thrun_recovery_probability_estimator.hpp:40-95).  The state is tensors
on the particles' device, one entry per filter (0-d for one filter), so
the update never reads back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor

_EPS32 = float(torch.finfo(torch.float32).eps)


class ExpFilterState(NamedTuple):
    value: Tensor  # f32
    seeded: Tensor  # bool

    @staticmethod
    def init(device=None, shape=()) -> "ExpFilterState":
        return ExpFilterState(
            torch.zeros(shape, dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=torch.bool, device=device),
        )


def exp_filter_update(state: ExpFilterState, alpha: float, x: Tensor) -> ExpFilterState:
    new_value = torch.where(state.seeded, state.value + alpha * (x - state.value), x)
    return ExpFilterState(new_value.float(), torch.ones_like(state.seeded))


class ThrunState(NamedTuple):
    slow: ExpFilterState
    fast: ExpFilterState

    @staticmethod
    def init(device=None, shape=()) -> "ThrunState":
        return ThrunState(ExpFilterState.init(device, shape), ExpFilterState.init(device, shape))


def thrun_update(
    state: ThrunState, alpha_slow: float, alpha_fast: float, average_weight: Tensor
) -> tuple[ThrunState, Tensor]:
    """Returns (new state, random-state probability in [0, 1])."""
    slow = exp_filter_update(state.slow, alpha_slow, average_weight)
    fast = exp_filter_update(state.fast, alpha_fast, average_weight)
    safe_slow = torch.where(torch.abs(slow.value) < 1e-38, 1.0, slow.value)
    prob = torch.where(
        torch.abs(slow.value) < _EPS32,
        0.0,
        torch.clamp(1.0 - fast.value / safe_slow, 0.0, 1.0),
    )
    return ThrunState(slow, fast), prob
