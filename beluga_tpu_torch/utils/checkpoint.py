"""Filter-state checkpoints (port of ``beluga_tpu/utils/checkpoint.py``).

The reference node keeps only its last pose estimate across map swaps
(amcl_node.cpp:450-497).  With the filter's state in dense tensors a full
checkpoint is cheap: the particles, the Thrun filters, the host gates and
the odometry memory, and the ``torch.Generator``'s state, so that a filter
restored after k updates draws what the saved one would have drawn and
continues bit for bit.

Any tree of tensors, ``torch.Generator`` objects, numpy arrays and Python
scalars under dataclasses, named tuples and tuples works: an ``AmclState``,
a fleet's, a custom filter's.

The state of a filter or fleet split over ``torch.distributed`` ranks
(``parallel/mega.py:shard_mega_state``, ``parallel/fleet.py:shard_fleet``)
is saved by :func:`save_state_sharded`, each rank writing only its own
block, and restored by :func:`load_state_sharded` onto the template's mesh,
which may have another number of ranks.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch


def _leaves(tree: Any, out: list) -> None:
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _leaves(getattr(tree, f.name), out)
    elif isinstance(tree, tuple):
        for item in tree:
            _leaves(item, out)
    elif tree is not None:
        out.append(tree)


def _rebuild(template: Any, leaves) -> Any:
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _rebuild(getattr(template, f.name), leaves)
            for f in dataclasses.fields(template)})
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(item, leaves) for item in template))
    if isinstance(template, tuple):
        return tuple(_rebuild(item, leaves) for item in template)
    if template is None:
        return None
    return next(leaves)


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_state(path: str, state: Any) -> None:
    """Save a state tree to an ``.npz`` file, one array a leaf in tree
    order (a generator as its state bytes)."""
    leaves: list = []
    _leaves(state, leaves)
    arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)}
    np.savez_compressed(path, num_leaves=np.int64(len(leaves)), **arrays)


def _restore(arr: np.ndarray, t: Any, i: int) -> Any:
    if isinstance(t, torch.Generator):
        g = torch.Generator(device=t.device)
        g.set_state(torch.from_numpy(arr.copy()))
        return g
    if tuple(np.shape(t)) != arr.shape:
        raise ValueError(f"leaf {i}: checkpoint shape {arr.shape} != template "
                         f"{tuple(np.shape(t))}")
    if isinstance(t, torch.Tensor):
        return torch.from_numpy(arr.copy()).to(device=t.device, dtype=t.dtype)
    if isinstance(t, np.ndarray):
        return arr.astype(t.dtype)
    return type(t)(arr.item())  # a Python scalar


def load_state(path: str, template: Any) -> Any:
    """Restore a state saved by :func:`save_state`.  ``template`` gives
    the tree, each leaf's dtype and device, typically a freshly
    initialized state of the same configuration; it is not modified (a
    generator is restored into a new one on the template's device)."""
    data = np.load(path)
    n = int(data["num_leaves"])
    t_leaves: list = []
    _leaves(template, t_leaves)
    if len(t_leaves) != n:
        raise ValueError(f"checkpoint has {n} leaves but template has {len(t_leaves)}")
    restored = [_restore(data[f"leaf_{i}"], t, i) for i, t in enumerate(t_leaves)]
    return _rebuild(template, iter(restored))


def _sharded_leaves(mesh, state: Any) -> list:
    """``(leaf, spec)`` pairs of a sharded state in :func:`_leaves` order;
    the spec names the mesh dimension that splits each axis (``None`` for
    a generator, which each rank holds alone)."""
    from beluga_tpu_torch.parallel.placement import map_specs, state_sharding

    pairs: list = []

    def add(leaf, spec):
        if leaf is None:
            return
        if isinstance(leaf, tuple):  # the two generators of ShardGenerators
            pairs.extend((g, None) for g in leaf)
        else:
            pairs.append((leaf, spec))

    map_specs(add, state, state_sharding(mesh, state))
    return pairs


def _block(mesh, shape, spec) -> tuple[np.ndarray, np.ndarray]:
    """``(offsets, global shape)`` of this rank's block of a leaf."""
    from beluga_tpu_torch.parallel.placement import axis_size

    offsets, full = np.zeros(len(shape), np.int64), np.asarray(shape, np.int64)
    for axis, name in enumerate(spec or ()):
        if name is not None:
            offsets[axis] = mesh.get_local_rank(name) * shape[axis]
            full[axis] = shape[axis] * axis_size(mesh, name)
    return offsets, full


def save_state_sharded(path: str, state: Any, mesh) -> None:
    """Save this rank's part of a sharded state into the directory
    ``path``: ``rank{r:05d}.npz`` with every leaf's block, its offsets in
    the whole array and the whole array's shape, and the generators'
    states; rank 0 also writes ``index.json``.  Every rank of the default
    group must call it; no array is gathered."""
    import torch.distributed as dist

    rank = dist.get_rank()
    os.makedirs(path, exist_ok=True)
    arrays = {}
    for i, (leaf, spec) in enumerate(_sharded_leaves(mesh, state)):
        arr = _to_numpy(leaf)
        arrays[f"leaf_{i}"] = arr
        if not isinstance(leaf, torch.Generator):
            arrays[f"offset_{i}"], arrays[f"shape_{i}"] = _block(mesh, arr.shape, spec)
    np.savez(os.path.join(path, f"rank{rank:05d}.npz"), num_leaves=np.int64(len(arrays)),
             **arrays)
    if rank == 0:
        with open(os.path.join(path, "index.json"), "w") as f:
            json.dump({"world": dist.get_world_size(),
                       "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}, f)
    dist.barrier()


def load_state_sharded(path: str, template: Any, mesh) -> Any:
    """Restore a state saved by :func:`save_state_sharded` onto the layout
    of ``template`` (a sharded state on ``mesh``, e.g. from
    ``shard_mega_state`` of a fresh state): each leaf's block is assembled
    from the saved blocks that overlap it, so the mesh may have another
    number of ranks than the one that saved.  A generator is restored from
    the file of the same rank; a rank that did not save keeps the
    template's."""
    import torch.distributed as dist

    with open(os.path.join(path, "index.json")) as f:
        saved_world = json.load(f)["world"]
    files = [np.load(os.path.join(path, f"rank{r:05d}.npz")) for r in range(saved_world)]
    rank = dist.get_rank()
    restored = []
    for i, (t, spec) in enumerate(_sharded_leaves(mesh, template)):
        if isinstance(t, torch.Generator):
            own = rank < saved_world
            restored.append(_restore(files[rank][f"leaf_{i}"], t, i) if own else t)
            continue
        shape = tuple(np.shape(t))
        lo, full = _block(mesh, shape, spec)
        hi = lo + np.asarray(shape, np.int64)
        out, filled = None, np.zeros(shape, bool)
        for data in files:
            if tuple(data[f"shape_{i}"]) != tuple(full):
                raise ValueError(f"leaf {i}: saved whole shape {tuple(data[f'shape_{i}'])} "
                                 f"!= template's {tuple(full)}")
            s_lo = data[f"offset_{i}"]
            block = data[f"leaf_{i}"]
            a, b = np.maximum(lo, s_lo), np.minimum(hi, s_lo + block.shape)
            if np.any(a >= b):
                continue
            if out is None:
                out = np.empty(shape, block.dtype)
            into = tuple(slice(x, y) for x, y in zip(a - lo, b - lo))
            out[into] = block[tuple(slice(x, y) for x, y in zip(a - s_lo, b - s_lo))]
            filled[into] = True
            if filled.all():  # replicas of a block (other ranks' copies) add nothing
                break
        if not filled.all():
            raise ValueError(f"leaf {i}: the saved blocks cover {int(filled.sum())} of its "
                             f"{filled.size} entries")
        restored.append(_restore(out, t, i))
    return _rebuild(template, iter(restored))
