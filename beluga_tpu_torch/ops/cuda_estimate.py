"""Kernel E1: the SE2 estimate, every filter's weighted mean and covariance
in one launch.

It replaces no Pallas kernel: ``beluga_tpu/algorithms/estimation.py:
estimate_se2`` leaves the moments to XLA's reductions, which the port ran as
~38 PyTorch operations and a batched GEMM.  The kernel is
``csrc/estimate.cu``; its plain version is
``algorithms/estimation.py:estimate_se2_reference``, which
``estimate_se2`` and ``estimate_se2_log`` run on CPU tensors.  The entries
here take CUDA tensors only, and raise on anything else.

Two entries share the kernel: :func:`estimate_se2_log` takes a particle
set's log-weights and live prefix (the main paths' call: the weights are
formed in registers and never stored), :func:`estimate_se2_weights` linear
weights and an optional mask (``estimate_se2``'s own arguments).  Each
filter's particles must be contiguous; its filter axes may be strided
(one stride from filter to filter, 0 where an input is broadcast).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from beluga_tpu_torch.lie import SE2, SO2
from beluga_tpu_torch.ops._build import Entry, stream_ptr

Tensor = torch.Tensor

THREADS = 512  # csrc/estimate.cu kThreads: a tile is 2 * THREADS * pairs slots
PARTIAL = 11  # floats of one tile's partial moments
MAX_SLOTS = 2**30

# kernel launches since the count was last set to 0
launches = 0

_p, _ll, _i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_estimate = Entry("estimate", "beluga_estimate_se2",
                  [_p, _ll, _p, _ll, _p, _p, _ll, _p, _ll, _i, _i, _i, _i, _i, _p, _p, _p, _p, _p,
                   _p],
                  "estimate kernel launch", expect={"beluga_estimate_threads": THREADS})


@functools.lru_cache(maxsize=256)
def estimate_plan(n: int, filters: int, sms: int) -> tuple[int, int]:
    """``(pairs, chunks)`` of the launch for ``filters`` filters of ``n``
    slots on a card of ``sms`` SMs: tiles of 4096 slots (4 pairs a thread),
    or of 2048 where 4096-slot tiles would give fewer blocks than SMs; a
    filter spans ``chunks`` tiles (at least one)."""
    pairs = 4 if filters * -(-n // (8 * THREADS)) >= sms else 2
    return pairs, max(1, -(-n // (2 * THREADS * pairs)))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# the tiles' partials and the filters' counts by (card, stream): kept between
# calls, the counts zero (every launch leaves them so), one set a stream so
# that no two launches share them at once
_scratch: dict[tuple[int, int], tuple[Tensor, Tensor]] = {}


def _scratch_for(device: torch.device, stream: int, filters: int,
                 chunks: int) -> tuple[Tensor, Tensor]:
    key = (device.index, stream)
    partials, counts = _scratch.get(key, (None, None))
    if partials is None or partials.numel() < filters * chunks * PARTIAL:
        partials = torch.empty(filters * chunks * PARTIAL, dtype=torch.float32, device=device)
    if counts is None or counts.numel() < filters:
        counts = torch.zeros(filters, dtype=torch.int32, device=device)
    _scratch[key] = partials, counts
    return partials, counts


def _row_stride(shape, strides, lead: int, inner: tuple[int, ...], name: str) -> int:
    """The stride from one filter's row to the next of a tensor shaped
    ``shape[:lead]`` filters of rows ``shape[lead:]``, which must be
    contiguous (``inner`` their strides): one stride for every filter axis
    (0 where broadcast), else a ``ValueError``."""
    for size, stride, want in zip(shape[lead:], strides[lead:], inner):
        if size > 1 and stride != want:
            raise ValueError(f"{name} must be contiguous along its particle axis, got strides "
                             f"{list(strides)} for shape {list(shape)}")
    step, span = None, None
    for size, stride in reversed(list(zip(shape[:lead], strides[:lead]))):
        if size == 1:
            continue
        if step is None:
            step = stride
        elif stride != span:
            raise ValueError(f"{name}'s filter axes do not flatten to one stride: strides "
                             f"{list(strides)} for shape {list(shape)}")
        span = stride * size
    return 0 if step is None else step


@functools.lru_cache(maxsize=256)
def _layout(xy, z, w, mask, active) -> tuple:
    """The entries' checks on ``(shape, strides, dtype, device)`` of each
    input (raising on what the kernel does not take), cached by them:
    ``(lead, n, filters, row strides of w, mask, xy and z)``."""
    xshape, xstrides, xdtype, device = xy
    if device.type != "cuda":
        raise ValueError(f"kernel E1 takes CUDA tensors, got {device}: the plain version is "
                         "algorithms/estimation.py:estimate_se2_reference")
    if xdtype != torch.float32 or len(xshape) < 2 or xshape[-1] != 2:
        raise ValueError(f"states.xy must be float32[..., N, 2], got {xdtype}{list(xshape)}")
    lead, n = tuple(xshape[:-2]), xshape[-2]
    if n >= MAX_SLOTS:
        raise ValueError(f"{n} particles a filter; the kernel takes fewer than {MAX_SLOTS}")
    k = len(lead)
    strides = {}
    for name, spec, shape, dtype, inner in (
            ("states.xy", xy, (*lead, n, 2), torch.float32, (2, 1)),
            ("states.rot.z", z, (*lead, n, 2), torch.float32, (2, 1)),
            ("the weights", w, (*lead, n), torch.float32, (1,)),
            ("the mask", mask, (*lead, n), torch.bool, (1,)),
            ("active", active, lead, torch.int32, ())):
        if spec is None:
            continue
        tshape, tstrides, tdtype, tdevice = spec
        if tdevice != device:
            raise ValueError(f"{name} is on {tdevice}, states.xy on {device}")
        if tdtype != dtype or tuple(tshape) != shape:
            raise ValueError(f"{name} must be {dtype}{list(shape)}, got {tdtype}{list(tshape)}")
        strides[name] = _row_stride(tshape, tstrides, k, inner, name)
    return (lead, n, math.prod(lead), strides.get("the weights"), strides.get("the mask", 0),
            strides["states.xy"], strides["states.rot.z"], strides.get("active"))


def _spec(t: Tensor | None):
    return None if t is None else (tuple(t.shape), t.stride(), t.dtype, t.device)


def _launch(states: SE2, w: Tensor, mask: Tensor | None, active: Tensor | None):
    global launches
    xy, z = states.xy, states.rot.z
    lead, n, filters, w_stride, mask_stride, xy_stride, z_stride, active_stride = _layout(
        _spec(xy), _spec(z), _spec(w), _spec(mask), _spec(active))
    if active is not None and filters > 1 and active_stride != 1:
        raise ValueError("active must be contiguous")
    device = xy.device
    out = torch.empty(13 * filters, dtype=torch.float32, device=device)
    cov = out[:9 * filters].view(*lead, 3, 3)
    mean = SE2(out[9 * filters:11 * filters].view(*lead, 2),
               SO2(out[11 * filters:].view(*lead, 2)))
    if filters == 0:
        return mean, cov
    pairs, chunks = estimate_plan(n, filters, _sms(device.index))
    stream = stream_ptr(device)
    partials = counts = None
    if chunks > 1:
        partials, counts = _scratch_for(device, stream, filters, chunks)
    vec = (w.data_ptr() % 8 == 0 and w_stride % 2 == 0 and xy.data_ptr() % 16 == 0
           and xy_stride % 4 == 0 and z.data_ptr() % 16 == 0 and z_stride % 4 == 0)
    _estimate(
        w.data_ptr(), w_stride, None if mask is None else mask.data_ptr(), mask_stride,
        None if active is None else active.data_ptr(), xy.data_ptr(), xy_stride,
        z.data_ptr(), z_stride, n, filters, chunks, pairs, int(vec),
        None if partials is None else partials.data_ptr(),
        None if counts is None else counts.data_ptr(),
        cov.data_ptr(), mean.xy.data_ptr(), mean.rot.z.data_ptr(), stream)
    launches += 1
    return mean, cov


def estimate_se2_log(states: SE2, log_weight: Tensor, active: Tensor):
    """``(SE2 mean [...], f32[..., 3, 3] covariance)`` of the weights
    ``slot < active ? exp(log_weight) : 0`` in one launch: ``states`` with
    ``xy`` and ``rot.z`` ``f32[..., N, 2]``, ``log_weight`` ``f32[..., N]``
    and ``active`` ``int32[...]``, on one card.  Slots past ``active`` are
    not read.  The checks are cached by the tensors' shapes, strides,
    dtypes and devices."""
    return _launch(states, log_weight, None, active)


def estimate_se2_weights(states: SE2, weights: Tensor, mask: Tensor | None = None):
    """:func:`estimate_se2_log`'s estimate of linear ``weights``
    ``f32[..., N]`` (broadcast to the states' filter axes, as the plain
    version does), zero where ``mask`` (``bool[..., N]``) is False."""
    lead = states.xy.shape[:-1]
    weights = torch.broadcast_to(weights, lead)
    if mask is not None:
        mask = torch.broadcast_to(mask, lead)
    return _launch(states, weights, mask, None)
