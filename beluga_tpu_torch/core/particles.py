"""Dense particle storage (port of ``beluga_tpu/core/particles.py``).

A particle set has a static capacity ``N`` and an active count: slots
``>= active`` are dead padding, and the alive particles are the prefix
``[0, active)``.  ``active`` is a 0-d int32 tensor on the particles' device,
so the adaptive (KLD) count never has to be read back to the host.

State "trees" are tensors, or frozen dataclasses / NamedTuples of them
(``SE2``, ``ThrunState``); :func:`tree_map` walks them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

Tensor = torch.Tensor

# Log-weight of dead slots: finite (not -inf) so masked arithmetic never
# produces NaNs; consumers still mask explicitly.
DEAD_LOG_WEIGHT = -1e30


def tree_map(fn: Callable, *trees: Any) -> Any:
    """Apply ``fn`` leaf-wise across tensors, dataclasses and NamedTuples."""
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    if dataclasses.is_dataclass(t0):
        return type(t0)(**{
            f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(t0)
        })
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*(tree_map(fn, *leaves) for leaves in zip(*trees)))
    raise TypeError(f"not a tensor tree: {type(t0).__name__}")


def tree_leaves(tree: Any) -> list[Tensor]:
    out: list[Tensor] = []
    tree_map(lambda leaf: out.append(leaf), tree)
    return out


@dataclasses.dataclass(frozen=True)
class ParticleSet:
    """Weighted particles with static capacity.

    Attributes:
      state: a tensor tree whose leaves have leading dimension ``N``.
      log_weight: ``f32[N]`` unnormalized log-weights; dead slots hold
        ``DEAD_LOG_WEIGHT``.
      active: 0-d int32 tensor, the number of alive particles (prefix).
    """

    state: Any
    log_weight: Tensor
    active: Tensor

    @property
    def capacity(self) -> int:
        return self.log_weight.shape[-1]

    @property
    def mask(self) -> Tensor:
        """``bool[N]`` alive mask."""
        return torch.arange(self.capacity, device=self.log_weight.device) < self.active

    @property
    def weight(self) -> Tensor:
        """Linear weights, zero on dead slots."""
        return torch.where(self.mask, torch.exp(self.log_weight), 0.0)

    def replace(self, **kw) -> "ParticleSet":
        return dataclasses.replace(self, **kw)


def make_from_states(states: Any, active: Tensor | int | None = None) -> ParticleSet:
    """Particle set with unit weights (log-weight 0) on the first ``active``
    slots (``beluga::make_from_state``, particle_traits.hpp:96)."""
    leaf = tree_leaves(states)[0]
    n, device = leaf.shape[0], leaf.device
    if active is None:
        active = n
    if isinstance(active, int):
        active = torch.full((), active, dtype=torch.int32, device=device)
    active = active.to(torch.int32)
    alive = torch.arange(n, device=device) < active
    log_w = torch.where(
        alive,
        torch.zeros((), dtype=torch.float32, device=device),
        torch.full((), DEAD_LOG_WEIGHT, dtype=torch.float32, device=device),
    )
    return ParticleSet(state=states, log_weight=log_w, active=active)


def tree_take(states: Any, indices: Tensor) -> Any:
    """``states[indices]`` across every leaf."""
    return tree_map(lambda leaf: leaf.index_select(0, indices), states)


def tree_scatter(base: Any, indices: Tensor, updates: Any) -> Any:
    """``base[indices[j]] = updates[j]`` across every leaf; indices outside
    ``[0, N)`` are dropped (callers mask invalid slots with ``N``)."""

    def scatter(b: Tensor, u: Tensor) -> Tensor:
        keep = (indices >= 0) & (indices < b.shape[0])
        out = b.clone()
        out[indices[keep]] = u[keep]
        return out

    return tree_map(scatter, base, updates)


def tree_where(mask: Tensor, a: Any, b: Any) -> Any:
    """Elementwise select between two state trees; ``mask`` broadcasts over
    each leaf's trailing dimensions."""

    def sel(x: Tensor, y: Tensor) -> Tensor:
        m = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
        return torch.where(m, x, y)

    return tree_map(sel, a, b)
