"""Dense particle storage (port of ``beluga_tpu/core/particles.py``).

A particle set has a static capacity ``N`` and an active count: slots
``>= active`` are dead padding, and the alive particles are the prefix
``[0, active)``.  ``active`` is an int32 tensor on the particles' device, so
the adaptive (KLD) count never has to be read back to the host.

Every function takes leading filter axes: a fleet of B filters holds
``log_weight f32[B, N]``, ``active i32[B]`` and states shaped ``[B, N]``
(an ``SE2`` with ``xy f32[B, N, 2]``); the particle axis is the last axis
of ``log_weight``.

State "trees" are tensors, or frozen dataclasses / tuples of them
(``SE2``, ``ThrunState``); :func:`tree_map` walks them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

Tensor = torch.Tensor

# Log-weight of dead slots: finite (not -inf) so masked arithmetic never
# produces NaNs; consumers still mask explicitly.
DEAD_LOG_WEIGHT = -1e30


def tree_map(fn: Callable, *trees: Any) -> Any:
    """Apply ``fn`` leaf-wise across tensors, dataclasses and tuples;
    ``None`` is an empty subtree, as in JAX."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    if dataclasses.is_dataclass(t0):
        return type(t0)(**{
            f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(t0)
        })
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*(tree_map(fn, *leaves) for leaves in zip(*trees)))
    if isinstance(t0, tuple):
        return tuple(tree_map(fn, *leaves) for leaves in zip(*trees))
    raise TypeError(f"not a tensor tree: {type(t0).__name__}")


def tree_leaves(tree: Any) -> list[Tensor]:
    out: list[Tensor] = []
    tree_map(lambda leaf: out.append(leaf), tree)
    return out


@dataclasses.dataclass(frozen=True)
class ParticleSet:
    """Weighted particles with static capacity.

    Attributes:
      state: a tensor tree whose leaves are shaped ``[..., N, ...]``, the
        filter axes first.
      log_weight: ``f32[..., N]`` unnormalized log-weights; dead slots
        hold ``DEAD_LOG_WEIGHT``.
      active: int32 ``[...]``, the number of alive particles (prefix) of
        each filter.
    """

    state: Any
    log_weight: Tensor
    active: Tensor

    @property
    def capacity(self) -> int:
        return self.log_weight.shape[-1]

    @property
    def mask(self) -> Tensor:
        """``bool[..., N]`` alive mask."""
        return (torch.arange(self.capacity, device=self.log_weight.device)
                < self.active[..., None])

    @property
    def weight(self) -> Tensor:
        """Linear weights, zero on dead slots."""
        return torch.where(self.mask, torch.exp(self.log_weight), 0.0)

    def replace(self, **kw) -> "ParticleSet":
        return dataclasses.replace(self, **kw)


def make_from_states(states: Any, active: Tensor | int | None = None,
                     batch_dims: int | None = None) -> ParticleSet:
    """Particle set with unit weights (log-weight 0) on the first ``active``
    slots (``beluga::make_from_state``, particle_traits.hpp:96).

    ``batch_dims`` is the number of leading filter axes; by default the
    number of axes of ``active`` (0 for a count given as an int)."""
    if batch_dims is None:
        batch_dims = active.dim() if isinstance(active, torch.Tensor) else 0
    leaf = tree_leaves(states)[0]
    lead, device = tuple(leaf.shape[:batch_dims]), leaf.device
    n = leaf.shape[batch_dims]
    if active is None:
        active = n
    if isinstance(active, int):
        active = torch.full(lead, active, dtype=torch.int32, device=device)
    active = active.to(torch.int32)
    alive = torch.arange(n, device=device) < active[..., None]
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
    """``base[..., indices[..., j]] = updates[..., j]`` along the particle
    axis of every leaf, with the filter axes ``[...]`` of ``indices``
    first; indices outside ``[0, N)`` are dropped (callers mask invalid
    slots with ``N``).  Nothing is read back: dropped entries land in a
    spare slot that is cut off.  Of entries with the same index the last
    one is written, on every device and in every run (JAX's scatter leaves
    the order unspecified, and so does a CUDA ``index_copy_``: the filter's
    result would depend on the run)."""
    lead = tuple(indices.shape[:-1])
    rows = math.prod(lead)
    n = tree_leaves(base)[0].shape[len(lead)]
    idx = torch.where((indices >= 0) & (indices < n), indices, n).long().reshape(rows, -1)
    # an entry followed by another of its index (a stable sort keeps their
    # order) goes to the spare slot
    ordered, perm = torch.sort(idx, dim=-1, stable=True)
    later = torch.zeros_like(ordered, dtype=torch.bool)
    later[:, :-1] = ordered[:, 1:] == ordered[:, :-1]
    idx = torch.where(torch.zeros_like(later).scatter_(-1, perm, later), n, idx)
    idx = idx + (n + 1) * torch.arange(rows, device=idx.device)[:, None]

    def scatter(b: Tensor, u: Tensor) -> Tensor:
        tail = b.shape[len(lead) + 1:]
        out = torch.cat([b.reshape(rows, n, *tail), b.reshape(rows, n, *tail)[:, :1]], dim=1)
        out.view(rows * (n + 1), *tail).index_copy_(0, idx.reshape(-1),
                                                    u.reshape(-1, *tail))
        return out[:, :n].reshape(b.shape)

    return tree_map(scatter, base, updates)


def tree_sort_by(key: Tensor, states: Any) -> Any:
    """Reorder a state tree by ascending ``key`` ``f32[..., N]`` along the
    particle axis (``lax.sort`` with one key, particles.py:105-126).  The
    sort is stable, as ``lax.sort`` is, so equal keys (the ``inf`` of dead
    slots) keep their order; every leaf is gathered with the one
    permutation."""
    axis = key.dim() - 1
    order = torch.sort(key, dim=-1, stable=True).indices

    def take(leaf: Tensor) -> Tensor:
        idx = order.reshape(order.shape + (1,) * (leaf.dim() - order.dim()))
        return torch.take_along_dim(leaf, idx, dim=axis)

    return tree_map(take, states)


def tree_where(mask: Tensor, a: Any, b: Any) -> Any:
    """Elementwise select between two state trees; ``mask`` broadcasts over
    each leaf's trailing dimensions."""

    def sel(x: Tensor, y: Tensor) -> Tensor:
        m = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
        return torch.where(m, x, y)

    return tree_map(sel, a, b)
