"""Filter-state checkpoints (port of ``beluga_tpu/utils/checkpoint.py``).

The reference node keeps only its last pose estimate across map swaps
(amcl_node.cpp:450-497).  With the filter's state in dense tensors a full
checkpoint is cheap: the particles, the Thrun filters, the host gates and
the odometry memory, and the ``torch.Generator``'s state, so that a filter
restored after k updates draws what the saved one would have drawn and
continues bit for bit.

Any tree of tensors, ``torch.Generator`` objects, numpy arrays and Python
scalars under dataclasses, named tuples and tuples works: an ``AmclState``,
a fleet's, a custom filter's.  The sharded checkpoints of the JAX package
(``save_state_sharded``) wait for the multi-GPU port.
"""

from __future__ import annotations

import dataclasses
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
