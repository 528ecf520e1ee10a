"""Kernel B2: the whole resample, from the weights to the donor rows.

Port of ``beluga_tpu/ops/pallas_resample.py``: :func:`resample_take`, its
tree form, the sorted-multinomial form and the residual form (two passes,
``beluga_tpu/filters/amcl.py:369-397``).  The kernels are
``csrc/resample.cu``, one launch a call each: :func:`monotone_cdf` builds
the CDF from the weights (at every length: past one tile of :data:`TILE`
weights its blocks wait for each other inside the launch, see
:func:`cdf_plan`), :func:`search_take` searches a CDF and copies the
donors, and :func:`resample_take` is the whole function: where a filter
fits one tile, one launch that scans the weights into shared memory and
searches there; past it, :func:`monotone_cdf` then :func:`search_take`.
On CUDA tensors each launches its kernel, and no PyTorch operation runs
between them; on CPU tensors each runs its plain PyTorch version
(:func:`monotone_cdf_reference`, :func:`search_take_reference`;
:func:`resample_take_reference` is the whole function's).
:func:`running_sum` is the CDF kernel without its division: the running
sums that the sorted positions (``ops/resample.py``) and the sharded CDF
(``parallel/collectives.py``) divide themselves.  The kernel sums in a
fixed order, so, unlike ``torch.cumsum`` past one CUB tile on the card, it
gives the same bits on every call.

Contract: the CDF is ``m / T``, ``m`` the running maximum of the float32
prefix sums over the slots of positive weight (0 before the first) and
``T`` its last entry, so a zero-weight slot's interval is empty however
the sum was associated; donor ``k`` of position ``u`` is the first slot
with ``cdf[k] > u``; a position at or above the last CDF entry (padding
``u = 1.5``) gets a zero row; donor rows are bit-exact copies.  Every input
may carry leading filter axes: a fleet passes weights ``[B, N]``,
positions ``[B, M]`` and planes ``[B, D, N]``, and each filter has its own
CDF.  The kernel's sums are associated in another order than
``torch.cumsum``'s, so its CDF and the plain version's differ by a few ulp
(within ``64 · 2^-24`` of a float64 prefix sum at N ≤ 2^21), and a position
between the two values of one entry takes the neighbouring donor.  The
one-tile entry builds the CDF with the CDF kernel's code, so its donors
are those of :func:`search_take` on :func:`monotone_cdf`'s CDF, bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Any

import torch

from beluga_tpu_torch.core.particles import tree_leaves, tree_map, tree_where
from beluga_tpu_torch.ops._build import Entry, stream_ptr, on_card
from beluga_tpu_torch.ops.resample import (
    interleave_slots,
    sorted_multinomial_positions,
    sorted_residual_from_uniform,
)

Tensor = torch.Tensor

MAX_FILTERS = 65535  # grid.y
TILE = 4096  # weights a block of the CDF kernel scans (csrc/resample.cu kTile)

# kernel launches since the counts were last set to 0, one a call: the
# search and donor copy on a CDF, the one-tile whole function, the CDF
# builds and the running sums
launches = 0
tile_launches = 0
cdf_launches = 0
sum_launches = 0

_p, _i = ctypes.c_void_p, ctypes.c_int
_TILE = {"beluga_cdf_tile": TILE}  # the entries that scan tiles check theirs
_cdf = Entry("resample", "beluga_cdf", [_p, _i, _i, _p, _i, _p, _i, _p], "CDF kernel launch",
             expect=_TILE)
_search = Entry("resample", "beluga_resample_take", [_p, _i, _p, _i, _p, _i, _p, _i, _p],
                "resample kernel launch")
_take_tile = Entry("resample", "beluga_resample_take_tile",
                   [_p, _i, _p, _i, _p, _i, _p, _i, _p], "one-tile resample launch",
                   expect=_TILE)
_blocks_per_sm = Entry("resample", "beluga_cdf_blocks_per_sm", [ctypes.POINTER(_i)],
                       "the CDF kernel's occupancy")


@dataclasses.dataclass(frozen=True)
class CdfPlan:
    """One launch of the CDF kernel over ``filters`` filters of ``n``
    weights: ``tiles`` of :data:`TILE` a filter and ``grid`` blocks.  A
    filter of one tile is a block of its own (``wait`` False).  Past one
    tile, a cooperative launch whose blocks wait for each other's partials
    (``wait``), published in the words of a scratch of shape ``scratch``
    (int64, zero when made, kept for later calls): the grid holds every
    (filter, tile) item where the card holds that many blocks at once (each
    block keeps its tile's weights across the wait), else as many blocks as
    it holds, each looping over items."""

    tiles: int
    grid: int
    wait: bool
    scratch: tuple[int, ...]


@functools.lru_cache(maxsize=256)
def cdf_plan(n: int, filters: int, sms: int, blocks_per_sm: int) -> CdfPlan:
    """The launch of the CDF kernel for ``filters`` filters of ``n > 0``
    weights on a card of ``sms`` SMs holding ``blocks_per_sm`` blocks of
    its waiting form each."""
    tiles = -(-n // TILE)
    if tiles == 1:
        return CdfPlan(tiles=1, grid=filters, wait=False, scratch=())
    if sms < 1 or blocks_per_sm < 1:
        raise RuntimeError(f"the CDF kernel's blocks do not fit the card ({blocks_per_sm} an "
                           f"SM on {sms} SMs): no grid can wait for itself")
    items = tiles * filters
    grid = min(items, sms * blocks_per_sm)
    return CdfPlan(tiles=tiles, grid=grid, wait=True, scratch=(filters, 2 + 2 * tiles))


# the CDF kernel's words by (card, stream, tiles): kept between calls, so
# that no call needs them reset (csrc/resample.cu), one set a stream, so
# that no two launches share them at once
_words: dict[tuple[int, int, int], Tensor] = {}


def _scratch(device: torch.device, stream: int, plan: CdfPlan) -> Tensor:
    key = (device.index, stream, plan.tiles)
    words = _words.get(key)
    if words is None or words.shape[0] < plan.scratch[0]:
        words = torch.zeros(plan.scratch, dtype=torch.int64, device=device)
        _words[key] = words
    return words


def one_launch_take(n: int) -> bool:
    """Whether :func:`resample_take` of filters of ``n`` weights is the
    one-tile entry (the CDF in shared memory, one launch) rather than the
    CDF kernel then the search."""
    return n <= TILE


@functools.lru_cache(maxsize=None)
def _card(index: int) -> tuple[int, int]:
    """``(SMs, co-resident CDF blocks an SM)`` of card ``index``."""
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(index):
        _blocks_per_sm(ctypes.byref(per_sm))
    return torch.cuda.get_device_properties(index).multi_processor_count, per_sm.value


def running_sum_reference(values: Tensor) -> Tensor:
    """Plain PyTorch version of the CDF kernel without its division:
    ``cumsum``, then the running maximum over slots with ``v > 0`` (0
    before the first), one row per filter along the last axis.  For
    nonnegative values on the CPU it is ``cumsum`` itself, bit for bit."""
    c = torch.cumsum(values, dim=-1)
    return torch.cummax(torch.where(values > 0, c, 0.0), dim=-1).values


def monotone_cdf_reference(weights: Tensor) -> Tensor:
    """Plain PyTorch version of the CDF kernel: :func:`running_sum_reference`
    divided by its last entry (at least 1e-38)."""
    m = running_sum_reference(weights)
    return m / torch.clamp_min(m[..., -1:], 1e-38)


def _scan(values: Tensor, normalize: bool) -> Tensor | None:
    """The CDF kernel's launch on CUDA ``values``, ``None`` on CPU ones
    (after the checks both devices share)."""
    if values.dtype != torch.float32 or values.dim() < 1 or values.shape[-1] == 0:
        raise ValueError(f"weights must be float32[..., N], N > 0, got "
                         f"{values.dtype}{list(values.shape)}")
    if not values.is_contiguous():
        raise ValueError("weights must be contiguous")
    filters, n = math.prod(values.shape[:-1]), values.shape[-1]
    if filters > MAX_FILTERS:
        raise ValueError(f"{filters} filters; the kernel takes at most {MAX_FILTERS}")
    if not on_card(values.device):
        return None
    device = values.device
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    plan = cdf_plan(n, filters, *_card(device.index))
    stream = stream_ptr(device)
    out = torch.empty_like(values)
    words = _scratch(device, stream, plan) if plan.wait else out  # unused at one tile
    _cdf(values.data_ptr(), n, filters, words.data_ptr(), int(normalize), out.data_ptr(),
         plan.grid, stream)
    return out


def monotone_cdf(weights: Tensor) -> Tensor:
    """The monotone CDF ``f32[..., N]`` of weights ``f32[..., N]``, one per
    filter (pallas_resample.py:405-412, zero-weight intervals empty):
    the CDF kernel on CUDA tensors, the plain version on CPU tensors."""
    global cdf_launches
    cdf = _scan(weights, normalize=True)
    if cdf is None:
        return monotone_cdf_reference(weights)
    cdf_launches += 1
    return cdf


def running_sum(values: Tensor) -> Tensor:
    """The running sum ``f32[..., N]`` of nonnegative ``values`` ``f32[...,
    N]``, one per filter, in the CDF kernel's fixed order (its running
    maximum over positive slots, undivided): the CDF kernel on CUDA
    tensors, the plain version (``torch.cumsum``'s bits) on CPU tensors."""
    global sum_launches
    m = _scan(values, normalize=False)
    if m is None:
        return running_sum_reference(values)
    sum_launches += 1
    return m


def search_take_reference(cdf: Tensor, positions: Tensor, values: Tensor) -> Tensor:
    """Plain PyTorch version of the search kernel: ``searchsorted`` (side
    right) and a gather; ``f32[..., M, D]``."""
    n, d = cdf.shape[-1], values.shape[-2]
    idx = torch.searchsorted(cdf, positions, right=True)
    found = idx < n
    safe = torch.clamp_max(idx, n - 1)[..., None, :].expand(*idx.shape[:-1], d, idx.shape[-1])
    rows = torch.take_along_dim(values, safe, dim=-1).transpose(-1, -2)
    return torch.where(found[..., None], rows, 0.0)


def resample_take_reference(weights: Tensor, positions: Tensor, values: Tensor) -> Tensor:
    """Plain PyTorch version of the whole function: the CDF, ``searchsorted``
    and the gather."""
    return search_take_reference(monotone_cdf_reference(weights), positions, values)


def _check(cdf: Tensor, positions: Tensor, values: Tensor, name: str = "cdf") -> bool:
    """The checks both devices share; whether the kernel runs."""
    device = cdf.device
    for label, t in ((name, cdf), ("positions", positions), ("values", values)):
        if t.device != device:
            raise ValueError(f"{label} is on {t.device}, {name} on {device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{label} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{label} must be contiguous")
    if cdf.dim() < 1 or cdf.shape[-1] == 0:
        raise ValueError(f"{name} must be float32[..., N], N > 0, got {list(cdf.shape)}")
    lead, n = tuple(cdf.shape[:-1]), cdf.shape[-1]
    if positions.shape[:-1] != lead or positions.dim() != cdf.dim():
        raise ValueError(f"positions must be float32{list(lead) + ['M']}, "
                         f"got {list(positions.shape)}")
    if values.dim() != cdf.dim() + 1 or values.shape[:-2] != lead or values.shape[-1] != n:
        raise ValueError(f"values must be float32{list(lead) + ['D', n]}, got {list(values.shape)}")
    if math.prod(lead) > MAX_FILTERS:
        raise ValueError(f"{math.prod(lead)} filters; the kernel takes at most {MAX_FILTERS}")
    return on_card(device)


def _take(entry: Entry, first: Tensor, positions: Tensor, values: Tensor) -> Tensor:
    """One launch of the search entry (``first`` a CDF) or the one-tile
    entry (``first`` the weights): donor rows ``f32[..., M, D]``."""
    d, n = values.shape[-2:]
    m = positions.shape[-1]
    out = torch.empty((*positions.shape, d), dtype=torch.float32, device=first.device)
    entry(first.data_ptr(), n, positions.data_ptr(), m, values.data_ptr(), d, out.data_ptr(),
          math.prod(positions.shape[:-1]), stream_ptr(first.device))
    return out


def search_take(cdf: Tensor, positions: Tensor, values: Tensor) -> Tensor:
    """The search kernel's function on a monotone ``cdf`` f32[..., N]: donor
    rows ``f32[..., M, D]`` for ``positions`` f32[..., M] from ``values``
    f32[..., D, N].  Launches the kernel on CUDA tensors, runs the plain
    version on CPU tensors."""
    global launches
    if not _check(cdf, positions, values):
        return search_take_reference(cdf, positions, values)
    out = _take(_search, cdf, positions, values)
    launches += 1
    return out


def resample_take(weights: Tensor, positions: Tensor, values: Tensor) -> Tensor:
    """Donor states for every position: on the card, one launch of the
    one-tile entry where a filter holds at most :data:`TILE` weights
    (:func:`one_launch_take`), else :func:`monotone_cdf`, then
    :func:`search_take`; the plain versions on the CPU.

    Args:
      weights: ``f32[..., N]`` linear weights (zero on dead slots).
      positions: ``f32[..., M]`` in [0, 1); ``1.5`` pads a slot that takes none.
      values: ``f32[..., D, N]`` state planes.
    Returns ``f32[..., M, D]``.
    """
    global tile_launches
    if (weights.dtype != torch.float32 or weights.dim() < 1
            or weights.shape[:-1] != positions.shape[:-1]):
        raise ValueError(f"weights must be float32 with the positions' filter axes, "
                         f"got {weights.dtype}{list(weights.shape)}")
    weights = weights.contiguous()
    if not on_card(weights.device) or not one_launch_take(weights.shape[-1]):
        return search_take(monotone_cdf(weights), positions, values)
    _check(weights, positions, values, "weights")
    out = _take(_take_tile, weights, positions, values)
    tile_launches += 1
    return out


def pack_state(states: Any, batch_dims: int = 0) -> tuple[Tensor, Any]:
    """Flatten a state tree (leaves ``[..., N]`` or ``[..., N, k]`` after
    ``batch_dims`` filter axes) into ``f32[..., D, N]`` planes; returns the
    planes and the tree to unpack into."""
    leaves = tree_leaves(states)
    lead = tuple(leaves[0].shape[:batch_dims])
    n = leaves[0].shape[batch_dims]
    planes = torch.cat([leaf.reshape(*lead, n, -1).transpose(-1, -2).float()
                        for leaf in leaves], dim=-2)
    return planes.contiguous(), states


def unpack_state(packed: Tensor, like: Any) -> Any:
    """Inverse of :func:`pack_state` for ``packed`` ``f32[..., M, D]``,
    shaped like the tree ``like`` (with M particles in place of N)."""
    lead, m = tuple(packed.shape[:-2]), packed.shape[-2]
    b = len(lead)
    at = 0

    def take(leaf: Tensor) -> Tensor:
        nonlocal at
        trailing = tuple(leaf.shape[b + 1:])
        k = math.prod(trailing)
        out = packed[..., at : at + k].reshape(lead + (m,) + trailing)
        at += k
        return out

    return tree_map(take, like)


def resample_take_tree(weights: Tensor, positions: Tensor, states: Any) -> Any:
    """:func:`resample_take` over a state tree whose leaves carry the
    weights' filter axes."""
    packed, like = pack_state(states, weights.dim() - 1)
    return unpack_state(resample_take(weights, positions, packed), like)


def resample_take_tree_multinomial(
    generator: torch.Generator, weights: Tensor, states: Any, num: int,
    positions: Tensor | None = None, interleave: bool = True,
) -> Any:
    """Exact-multiset multinomial resample: sorted uniform order statistics
    (``positions``, drawn from ``generator`` when not given), the kernel,
    then, with ``interleave``, the slot interleave so slot prefixes cover
    the CDF uniformly.  Without it the donors stay in CDF order, which
    keeps theta-sorted slots sorted (pallas_resample.py:548-574)."""
    lead = tuple(weights.shape[:-1])
    if positions is None:
        positions = sorted_multinomial_positions(generator, num, lead)
    donors = resample_take_tree(weights, positions, states)
    if not interleave:
        return donors
    return tree_map(lambda leaf: interleave_slots(leaf, axis=len(lead)), donors)


def residual_positions(weights: Tensor, uniforms: Tensor, ranks: Tensor | None = None,
                       reduce=None):
    """The two passes' inputs of residual resampling for ``num`` donors a
    filter (amcl.py:369-397): ``(counts, u_det, residual, u_res, det)``.

    ``counts = floor(num·w)`` (``w`` normalized) are searched at the exact
    stratified positions ``u_det = (j + 0.5) / max(r0, 1)`` for the slots
    ``j < r0 = Σ counts`` (``det``), which find particle i exactly
    ``counts_i`` times, and at the padding ``1.5`` (no donor) from ``r0``
    on; ``residual = num·w - counts`` at ``u_res``,
    :func:`sorted_residual_from_uniform` of ``uniforms`` f32[..., num + 1].
    ``r0`` stays a device tensor per filter (the division is by it, not by
    a host number), so nothing is read back.

    For weights split across ranks (``parallel/mega.py``), ``weights`` is
    this rank's slice, ``reduce`` sums a per-filter total over the ranks
    and ``ranks`` (int64) names the global slots whose positions are
    wanted; ``counts`` and ``residual`` stay this rank's slices, to be
    gathered into the two CDFs."""
    num = uniforms.shape[-1] - 1
    reduce = reduce or (lambda t: t)
    total = reduce(torch.sum(weights, dim=-1, keepdim=True))
    w = weights / torch.clamp_min(total, 1e-38)
    counts = torch.floor(w * num)
    r0 = reduce(torch.sum(counts, dim=-1))
    slots = (torch.arange(num, dtype=torch.float32, device=weights.device) if ranks is None
             else ranks.to(torch.float32))
    det = slots < r0[..., None]
    u_det = torch.where(det, (slots + 0.5) / torch.clamp_min(r0, 1.0)[..., None], 1.5)
    u_res = sorted_residual_from_uniform(uniforms, r0)
    if ranks is not None:
        u_res = u_res.index_select(-1, ranks)
    return counts, u_det, w * num - counts, u_res, det


def resample_take_tree_residual(weights: Tensor, states: Any, uniforms: Tensor) -> Any:
    """Residual resampling through two passes of the kernel, the JAX
    package's accelerator branch (amcl.py:369-397): ``num`` donors a filter
    for ``uniforms`` f32[..., num + 1], the floor copies in the slots below
    ``r0`` and the residual draws from there on (:func:`residual_positions`),
    in CDF order, both passes ascending."""
    counts, u_det, residual, u_res, det = residual_positions(weights, uniforms)
    return tree_where(det, resample_take_tree(counts, u_det, states),
                      resample_take_tree(residual, u_res, states))
