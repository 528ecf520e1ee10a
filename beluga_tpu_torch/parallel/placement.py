"""Where the pieces of a filter's state live on a ``torch.distributed``
device mesh: each leaf's placement (:func:`state_sharding`), each rank's
block of a tree (:func:`place`), the broadcasts that give every rank the
same bits, and the generators of a sharded state (:class:`ShardGenerators`,
:func:`shard_generators`).  The sharded mega filter (``parallel/mega.py``),
the fleet on a ``("dp", "tp")`` mesh (``parallel/fleet.py``) and the sharded
checkpoints (``utils/checkpoint.py``) build on it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from beluga_tpu_torch.core.particles import ParticleSet

Tensor = torch.Tensor


class ShardGenerators(NamedTuple):
    """The generators of a sharded filter's state (``AmclState.generator``):
    ``rank`` this rank's own, ``shared`` the same on every rank of the
    group."""

    rank: torch.Generator
    shared: torch.Generator


def derive_seed(seed: int, *salt: int) -> int:
    """A 63-bit seed from ``seed`` and the integers ``salt`` (a rank, a mesh
    coordinate), the same on every process."""
    words = np.random.SeedSequence([int(seed), *map(int, salt)]).generate_state(2, np.uint32)
    return int(words.view(np.uint64)[0] >> np.uint64(1))


def seeded_generator(device, seed: int, *salt: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, *salt))
    return gen


def axis_size(mesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def broadcast_(t: Tensor, mesh) -> Tensor:
    """``t`` overwritten with the bits of mesh coordinate ``(0, ...)``: one
    broadcast along each mesh dimension, from its rank 0."""
    buf = t if t.is_contiguous() else t.contiguous()
    for dim in mesh.mesh_dim_names:
        group = mesh.get_group(dim)
        dist.broadcast(buf, src=dist.get_global_rank(group, 0), group=group)
    if buf is not t:
        t.copy_(buf)
    return t


def broadcast_seed(generator: torch.Generator, mesh) -> int:
    """The initial seed of ``generator`` on mesh coordinate ``(0, ...)``."""
    seed = torch.tensor([generator.initial_seed() & (2**63 - 1)], dtype=torch.int64,
                        device=generator.device)
    return int(broadcast_(seed, mesh).item())


def place(tree: Any, specs: Any, mesh) -> Any:
    """Each rank's block of ``tree`` under ``specs``, a tree of the same
    structure whose leaves name, per axis of the leaf, the mesh dimension
    that splits it (``None``: kept whole).  Tensors are first broadcast from
    mesh coordinate ``(0, ...)``, so that every rank cuts its block from the
    same bits; host leaves (numpy arrays, host poses) are cut as they are."""

    def cut(x, spec):
        if spec is None or isinstance(x, torch.Generator):
            return x
        if isinstance(x, torch.Tensor) and x.device.type == mesh.device_type:
            x = broadcast_(x.clone(), mesh)
        if not any(spec):
            return x
        for axis, name in enumerate(spec):
            if name is None:
                continue
            size, at = axis_size(mesh, name), mesh.get_local_rank(name)
            n = x.shape[axis]
            if n % size:
                raise ValueError(f"axis {axis} of size {n} does not divide into {size} ranks")
            index = (slice(None),) * axis + (slice(at * (n // size), (at + 1) * (n // size)),)
            x = x[index]
        return x.contiguous() if isinstance(x, torch.Tensor) else np.ascontiguousarray(x)

    return map_specs(cut, tree, specs)


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a state tree (named tuples, dataclasses,
    tensors, numpy arrays, Python scalars) and its spec tree; a generator,
    or a :class:`ShardGenerators`, is one leaf."""
    if isinstance(tree, ShardGenerators) or isinstance(tree, torch.Generator):
        return fn(tree, specs)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_specs(fn, getattr(tree, f.name), getattr(specs, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_specs(fn, t, s) for t, s in zip(tree, specs)))
    if isinstance(tree, tuple):
        return tuple(map_specs(fn, t, s) for t, s in zip(tree, specs))
    return fn(tree, specs)


def state_sharding(mesh, state: Any) -> Any:
    """The spec tree of an ``AmclState`` on ``mesh`` (see :func:`place`):
    the particle axis split by ``"tp"``, the filter axis of a fleet by
    ``"dp"``, each where the mesh has that dimension; the generator ``None``
    (each rank gets its own, :func:`shard_generators`)."""
    names = mesh.mesh_dim_names
    tp = "tp" if "tp" in names else None
    batch = state.particles.log_weight.dim() - 1
    dp = "dp" if "dp" in names and batch else None
    if batch > 1:
        raise ValueError("a sharded state has at most one filter axis")

    def spec(filter_axes: int, particle_axis: bool):
        def leaf_spec(x):
            ndim = np.ndim(x) if not isinstance(x, torch.Tensor) else x.dim()
            head = (dp,) * filter_axes + ((tp,) if particle_axis else ())
            return head + (None,) * (ndim - len(head))
        return leaf_spec

    per_filter = spec(batch, False)
    particle = spec(batch, True)

    def over(tree, fn):
        return map_specs(lambda x, _: fn(x), tree, tree)

    p = state.particles
    return state._replace(
        particles=ParticleSet(state=over(p.state, particle), log_weight=particle(p.log_weight),
                              active=per_filter(p.active)),
        generator=None,
        thrun=over(state.thrun, per_filter),
        resample_count=per_filter(state.resample_count),
        motion_latest=over(state.motion_latest, per_filter),
        motion_seeded=per_filter(state.motion_seeded),
        control_prev=over(state.control_prev, per_filter),
        control_seeded=per_filter(state.control_seeded),
        force_update=per_filter(state.force_update),
    )


def shard_generators(mesh, generator: torch.Generator, shared: bool, axis: str = "tp"):
    """This rank's generators from the seed of ``generator`` on mesh
    coordinate ``(0, ...)``: one seeded from ``(seed, coordinate)``, and
    with ``shared`` a :class:`ShardGenerators` whose ``shared`` generator is
    seeded from ``(seed, coordinate without axis)``, the same on the ranks
    of one ``axis`` group."""
    seed = broadcast_seed(generator, mesh)
    coord = [mesh.get_local_rank(d) for d in mesh.mesh_dim_names]
    rank = seeded_generator(generator.device, seed, 0, *coord)
    if not shared:
        return rank
    others = [c for d, c in zip(mesh.mesh_dim_names, coord) if d != axis]
    return ShardGenerators(rank, seeded_generator(generator.device, seed, 1, *others))
