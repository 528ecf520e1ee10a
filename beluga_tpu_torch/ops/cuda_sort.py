"""Kernel S1: the θ sort of ``sorted_slots`` SE2 filters, each filter's
sort key, its stable sort and the gather of its slots in one launch.

It replaces no Pallas kernel: ``beluga_tpu/filters/amcl.py:se2_sort_key``
and ``beluga_tpu/core/particles.py:tree_sort_by`` leave the key's
reductions, the sort and the gathers to XLA, which the port ran as ~40
PyTorch operations a call.  The kernel is ``csrc/sort_slots.cu``; its
plain version is ``filters/amcl.py:plain_sort_slots`` (``se2_sort_key``,
``inf`` off the mask, ``tree_sort_by``), which every call that
:func:`takes` refuses runs: CPU tensors, a filter of more than
:data:`MAX_SLOTS` slots, float64 or SE3 states.  The entry here takes
CUDA tensors only, and raises on anything else.

Each filter's slots must be contiguous; its filter axes may be strided
(one stride from filter to filter, as ``tree_scatter``'s rows of N + 1 cut
to N are).  The outputs are new contiguous tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from beluga_tpu_torch.lie import SE2, SO2
from beluga_tpu_torch.ops._build import Entry, on_card, row_stride, stream_ptr

Tensor = torch.Tensor

MAX_SLOTS = 4096  # csrc/sort_slots.cu kMaxSlots: one block a filter

# kernel launches since the count was last set to 0
launches = 0

_p, _ll, _i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_sort = Entry("sort_slots", "beluga_sort_slots_se2",
              [_p, _ll, _p, _ll, _p, _ll, _p, _ll, _i, _i, _p, _p, _p, _p, _p],
              "sort kernel launch", expect={"beluga_sort_max_slots": MAX_SLOTS})


@functools.lru_cache(maxsize=256)
def _layout(xy, z, w, active) -> tuple:
    """The entry's checks on ``(shape, strides, dtype, device)`` of each
    input (raising on what the kernel does not take), cached by them:
    ``(lead, n, filters, row strides of xy, z, w and active)``."""
    xshape, _, xdtype, device = xy
    if not on_card(device):
        raise ValueError(f"kernel S1 takes CUDA tensors, got {device}: the plain version is "
                         "filters/amcl.py:sort_slots' se2_sort_key and tree_sort_by")
    if xdtype != torch.float32 or len(xshape) < 2 or xshape[-1] != 2:
        raise ValueError(f"states.xy must be float32[..., N, 2], got {xdtype}{list(xshape)}")
    lead, n = tuple(xshape[:-2]), xshape[-2]
    if not 1 <= n <= MAX_SLOTS:
        raise ValueError(f"{n} slots a filter; the kernel takes 1 to {MAX_SLOTS}")
    strides = []
    for name, spec, shape, dtype, inner in (
            ("states.xy", xy, (*lead, n, 2), torch.float32, (2, 1)),
            ("states.rot.z", z, (*lead, n, 2), torch.float32, (2, 1)),
            ("the log-weights", w, (*lead, n), torch.float32, (1,)),
            ("active", active, lead, torch.int32, ())):
        tshape, tstrides, tdtype, tdevice = spec
        if tdevice != device:
            raise ValueError(f"{name} is on {tdevice}, states.xy on {device}")
        if tdtype != dtype or tuple(tshape) != shape:
            raise ValueError(f"{name} must be {dtype}{list(shape)}, got {tdtype}{list(tshape)}")
        strides.append(row_stride(tshape, tstrides, len(lead), inner, name))
    return (lead, n, math.prod(lead), *strides)


def _spec(t: Tensor):
    return (tuple(t.shape), t.stride(), t.dtype, t.device)


def takes(states) -> bool:
    """Whether ``filters/amcl.py:sort_slots`` sends ``states`` to S1: float32
    SE2 states on the card, 1 to :data:`MAX_SLOTS` slots a filter.  Their
    layout is not asked: :func:`sort_slots_se2` raises on one it does not
    read, as on an ``active`` that is not int32."""
    return (isinstance(states, SE2) and on_card(states.xy.device)
            and states.xy.dtype == torch.float32 and 1 <= states.xy.shape[-2] <= MAX_SLOTS)


def sort_slots_se2(states: SE2, log_weight: Tensor, active: Tensor, keys: bool = False):
    """``(states, log_weight)`` in the order of a stable ascending sort of
    ``se2_sort_key(states)``, ``inf`` at and past each filter's ``active``
    count, in one launch: ``states`` with ``xy`` and ``rot.z`` ``f32[...,
    N, 2]``, ``log_weight`` ``f32[..., N]`` and ``active`` ``int32[...]``
    on one card, 1 <= N <= :data:`MAX_SLOTS`.  With ``keys``, the keys
    ``f32[..., N]`` in slot order follow.  The checks are cached by the
    tensors' shapes, strides, dtypes and devices."""
    global launches
    xy, z = states.xy, states.rot.z
    lead, n, filters, xy_stride, z_stride, w_stride, active_stride = _layout(
        _spec(xy), _spec(z), _spec(log_weight), _spec(active))
    device = xy.device
    out_xy = torch.empty((*lead, n, 2), dtype=torch.float32, device=device)
    out_z = torch.empty((*lead, n, 2), dtype=torch.float32, device=device)
    out_w = torch.empty((*lead, n), dtype=torch.float32, device=device)
    out_key = torch.empty((*lead, n), dtype=torch.float32, device=device) if keys else None
    if filters:
        _sort(xy.data_ptr(), xy_stride, z.data_ptr(), z_stride, log_weight.data_ptr(), w_stride,
              active.data_ptr(), active_stride, n, filters, out_xy.data_ptr(), out_z.data_ptr(),
              out_w.data_ptr(), None if out_key is None else out_key.data_ptr(),
              stream_ptr(device))
        launches += 1
    out = (SE2(out_xy, SO2(out_z)), out_w)
    return (*out, out_key) if keys else out
