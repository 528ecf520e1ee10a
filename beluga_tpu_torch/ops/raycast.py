"""Ray casting over an occupancy grid with Bresenham parity (port of
``beluga_tpu/ops/raycast.py``), and kernel R1 with its two entries.

:func:`cast_rays`, the ray entry, launches kernel R1 (``csrc/raycast.cu``)
on CUDA tensors and runs :func:`cast_rays_reference`, the plain PyTorch
version, on CPU tensors.  :func:`exact_beam_weights`, the exact
beam-weights entry, is the whole of the JAX package's
``models/sensor/beam.py:beam_weights`` (and ``beam_log_weights``) in one
launch of the same kernel's march: the frame composition, each beam's
direction, the march, the mixture with the true ``erf``, the masked sum in
beam order and the clamped log; :func:`exact_beam_weights_reference` is its
plain version.  On the card both entries read the free mask as a bit plane
(:func:`pack_free_bits`, :class:`FreePlane`), packed once a grid and kept
on it (:func:`free_plane`).

The plain march is the reference's lock-step march written out: every ray
carries its own integer Bresenham state through ``ceil(max_range / res) +
2`` iterations; every 16 iterations the finished rays are written out and
dropped, and the loop stops once none is left (``done`` freezes the
reference's carry, so neither changes a result).

Semantics (raycasting.hpp:44-115, bresenham.hpp:34-230):
  * the line runs from the source cell ``floor(src / res)`` to the far
    cell ``floor((src + max_range * dir) / res)``;
  * distances are centroid to centroid, ``res * hypot(dx, dy)``, clamped
    to ``max_range``;
  * a ray that leaves the grid, or reaches the far cell without a hit, is
    a miss (distance ``max_range``); a non-free source cell hits at 0;
  * ``variant="supercover"`` is the reference's ``kModified`` line, which
    visits every cell the continuous line touches.

Contract: kernel and plain version visit the same cells, so hit flags and
distances agree bit for bit (every cell index divides by a tensor, never
through a reciprocal).  The exact entry's pz³ take the plain version's
float32 operations in its order (``erff`` and ``expf`` are the functions
``torch.erf`` and ``torch.exp`` call on the card), and its sums add the
unmasked beams in beam order as :func:`~beluga_tpu_torch.ops.cuda_beam.
masked_beam_sum` does: its tolerance against the plain version is rtol 1e-5
(bit-equal is the aim).  Against the JAX package the cells agree on the same
directions; a distance may differ by an ulp of ``hypot``, two after the
product with the resolution.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from beluga_tpu_torch.lie import SE2, SO2
from beluga_tpu_torch.ops._build import Entry, stream_ptr, on_card
from beluga_tpu_torch.ops.cuda_beam import Mixture, masked_beam_sum, mixture_pz3

Tensor = torch.Tensor

VARIANTS = ("standard", "supercover")
MAX_DIMS = 4  # broadcast axes the ray entry reads through strides
MAX_FILTERS = 65535  # grid.y of the exact entry
_PLANE_ATTR = "_r1_free_plane"  # where free_plane keeps a grid's plane

# kernel launches since the count was last set to 0: the ray entry and the
# exact beam-weights entry
launches = 0
exact_launches = 0

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_cast_rays = Entry("raycast", "beluga_cast_rays",
                   [_p, _i, _i, _i, _p, _p, _i, _p, _p, _p, _i, _f, _f, _i, _i, _p, _p, _p],
                   "raycast kernel launch")
_beam_exact = Entry("raycast", "beluga_beam_exact",
                    [_p, _i, _i, _i, _p, _p, _i, _i, _p, _p, _p, _i, _f, _f, _i, _i, _i, _p, _p,
                     _p],
                    "exact beam kernel launch")


# -- the free mask as a bit plane -------------------------------------------------


def pack_free_bits(free: Tensor) -> Tensor:
    """``int32[H, ceil(W / 32)]``: bit ``x % 32`` of word ``(y, x // 32)`` is
    ``free[y, x]``; each row is padded with non-free bits to whole words."""
    h, w = free.shape
    wpr = -(-w // 32)
    cells = torch.zeros((h, wpr * 32), dtype=torch.int64, device=free.device)
    cells[:, :w] = free.to(torch.int64)
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=free.device),
        torch.arange(32, dtype=torch.int64, device=free.device))
    words = (cells.reshape(h, wpr, 32) * weights).sum(-1)  # in [0, 2^32)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class FreePlane:
    """A grid's free mask packed for kernel R1 (:func:`pack_free_bits`), and
    ``world_to_grid``, ``grid.origin.inverse()``, as four host floats (x, y,
    cos, sin) in ``lie.py``'s operation order."""

    bits: Tensor
    world_to_grid: tuple


def free_plane(grid) -> FreePlane:
    """The :class:`FreePlane` of ``grid``, on the grid's device: packed at
    the first call and kept on the grid object, so that a filter packs it
    once a map.  A new map is a new grid, so a plane is never stale."""
    plane = vars(grid).get(_PLANE_ATTR)
    if plane is None:
        inv = SE2(grid.origin.xy.cpu(), SO2(grid.origin.rot.z.cpu())).inverse()
        world = tuple(float(v) for v in (*inv.xy.tolist(), *inv.rot.z.tolist()))
        plane = FreePlane(pack_free_bits(grid.free_mask).contiguous(), world)
        object.__setattr__(grid, _PLANE_ATTR, plane)  # the grid is a frozen dataclass
    return plane


def num_steps(max_range: float, resolution: float) -> int:
    """Iterations of the lock-step march: the driving axis advances at most
    ``ceil(max_range / res)`` times, +2 for the endpoints (raycast.py:66)."""
    return int(-(-max_range // resolution)) + 2


def line_ends(source: Tensor, direction: Tensor, max_range: float, resolution: float):
    """``(x0, y0, x1, y1)`` int32: the source cell and the far cell.  The
    product, the sum and the division are separate float32 operations, the
    division by a tensor on the rays' device."""
    res = torch.full((), resolution, dtype=torch.float32, device=source.device)
    src = torch.floor(source / res).to(torch.int32)
    far = torch.floor((source + max_range * direction) / res).to(torch.int32)
    return src[..., 0], src[..., 1], far[..., 0], far[..., 1]


class _March:
    """The carry shared by both variants over flat rays: distance, hit and
    done flags, the cells each ray has probed, and the rays' own integer
    state in ``rays``.  Every 16 iterations :meth:`settle` writes the
    finished rays out and drops them from the carry, which changes no
    result (``done`` freezes a ray)."""

    def __init__(self, free: Tensor, n: int, max_range: float, resolution: float, device,
                 rays: dict):
        self.free = free.reshape(-1)
        self.h, self.w = free.shape
        self.res = torch.full((), resolution, dtype=torch.float32, device=device)
        self.max_range = torch.full((), max_range, dtype=torch.float32, device=device)
        self.out_dist = torch.full((n,), max_range, dtype=torch.float32, device=device)
        self.out_hit = torch.zeros(n, dtype=torch.bool, device=device)
        self.out_cells = torch.zeros(n, dtype=torch.int64, device=device)
        self.ids = torch.arange(n, device=device)
        self.dist = self.out_dist.clone()
        self.hit = self.out_hit.clone()
        self.cells = self.out_cells.clone()
        self.done = torch.zeros(n, dtype=torch.bool, device=device)
        self.rays = rays

    def probe(self, x: Tensor, y: Tensor, da: Tensor, db: Tensor, cond: Tensor | None) -> None:
        """Check cells ``(x, y)`` where ``cond`` and not done: latch a hit
        at the centroid distance of ``(da, db)`` cells, or a miss outside."""
        inside = (x >= 0) & (x < self.w) & (y >= 0) & (y < self.h)
        idx = torch.clamp(y, 0, self.h - 1).long() * self.w + torch.clamp(x, 0, self.w - 1).long()
        active = ~self.done if cond is None else cond & ~self.done
        self.cells = self.cells + active
        blocked = active & inside & ~self.free[idx]
        d = self.res * torch.hypot(da.to(torch.float32), db.to(torch.float32))
        self.dist = torch.where(blocked, torch.minimum(d, self.max_range), self.dist)
        self.hit = self.hit | blocked
        self.done = self.done | blocked | (active & ~inside)

    def settle(self, i: int) -> bool:
        """Every 16th iteration: write out and drop the finished rays;
        True once none is left."""
        if i % 16 != 15:
            return False
        fin = self.done
        self.out_dist[self.ids[fin]] = self.dist[fin]
        self.out_hit[self.ids[fin]] = self.hit[fin]
        self.out_cells[self.ids[fin]] = self.cells[fin]
        keep = ~fin
        self.ids, self.dist, self.hit, self.cells, self.done = (
            v[keep] for v in (self.ids, self.dist, self.hit, self.cells, self.done))
        self.rays = {k: v[keep] for k, v in self.rays.items()}
        return self.ids.numel() == 0

    def result(self, shape):
        """``(dist, hit, cells)`` in ``shape``: ``cells`` the cells each
        ray probed, the kernel's work."""
        self.out_dist[self.ids] = self.dist
        self.out_hit[self.ids] = self.hit
        self.out_cells[self.ids] = self.cells
        return tuple(v.reshape(shape) for v in (self.out_dist, self.out_hit, self.out_cells))


def _standard(free, source, direction, max_range, resolution, steps):
    x0, y0, x1, y1 = (v.reshape(-1) for v in line_ends(source, direction, max_range,
                                                        resolution))
    dx, dy = torch.abs(x1 - x0), torch.abs(y1 - y0)
    m = _March(free, x0.numel(), max_range, resolution, source.device, dict(
        x=x0, y=y0, err=dx - dy, x0=x0, y0=y0, x1=x1, y1=y1, dx=dx, dy=dy,
        sx=torch.where(x1 >= x0, 1, -1).to(torch.int32),
        sy=torch.where(y1 >= y0, 1, -1).to(torch.int32)))
    zero = torch.zeros((), dtype=torch.int32, device=source.device)
    for i in range(steps):
        r = m.rays
        m.probe(r["x"], r["y"], r["x"] - r["x0"], r["y"] - r["y0"], None)
        m.done = m.done | ((r["x"] == r["x1"]) & (r["y"] == r["y1"]))
        e2 = 2 * r["err"]
        step_x = (e2 > -r["dy"]) & ~m.done
        step_y = (e2 < r["dx"]) & ~m.done
        r["err"] = r["err"] - torch.where(step_x, r["dy"], zero) + torch.where(step_y, r["dx"], zero)
        r["x"] = r["x"] + torch.where(step_x, r["sx"], zero)
        r["y"] = r["y"] + torch.where(step_y, r["sy"], zero)
        if m.settle(i):
            break
    return m.result(source.shape[:-1])


def _supercover(free, source, direction, max_range, resolution, steps):
    x0, y0, x1, y1 = (v.reshape(-1) for v in line_ends(source, direction, max_range,
                                                        resolution))
    xspan, yspan = torch.abs(x1 - x0), torch.abs(y1 - y0)
    xstep = torch.where(x1 >= x0, 1, -1).to(torch.int32)
    ystep = torch.where(y1 >= y0, 1, -1).to(torch.int32)
    # per-ray axis swap: the driving axis a has the larger span
    rev = xspan < yspan
    a0, b0 = torch.where(rev, y0, x0), torch.where(rev, x0, y0)
    aspan = torch.maximum(xspan, yspan)
    m = _March(free, x0.numel(), max_range, resolution, source.device, dict(
        rev=rev, a0=a0, b0=b0, aspan=aspan, astep=torch.where(rev, ystep, xstep),
        bstep=torch.where(rev, xstep, ystep), daspan=2 * aspan,
        dbspan=2 * torch.minimum(xspan, yspan), a=a0, b=b0, error=aspan))

    def probe(r, ca, cb, cond):
        m.probe(torch.where(r["rev"], cb, ca), torch.where(r["rev"], ca, cb), ca - r["a0"],
                cb - r["b0"], cond)

    probe(m.rays, a0, b0, None)  # the source cell
    m.done = m.done | (aspan == 0)
    for i in range(steps):
        r = m.rays
        m.done = m.done | ((i + 1) > r["aspan"])
        a, b, error = r["a"], r["b"], r["error"]
        a_new = a + r["astep"]
        e1 = error + r["dbspan"]
        diag = e1 > r["daspan"]
        b_new = torch.where(diag, b + r["bstep"], b)
        e2 = torch.where(diag, e1 - r["daspan"], e1)
        # intermediate cells (bresenham.hpp:141-156); on e2 + error == daspan
        # both are emitted (an exact corner crossing)
        probe(r, a_new, b, diag & (e2 + error <= r["daspan"]))
        probe(r, a, b_new, diag & (e2 + error >= r["daspan"]))
        probe(r, a_new, b_new, None)
        r["a"], r["b"], r["error"] = a_new, b_new, e2
        if m.settle(i):
            break
    return m.result(source.shape[:-1])


def cast_rays_reference(free: Tensor, source: Tensor, direction: Tensor, max_range: float,
                        resolution: float, steps: int, variant: str = "standard",
                        count_cells: bool = False):
    """Plain PyTorch version of kernel R1's ray entry on a ``bool[H, W]``
    free mask: ``(dist f32[...], hit bool[...])``, and with
    ``count_cells`` the cells each ray probed, ``int64[...]``."""
    march = _supercover if variant == "supercover" else _standard
    source, direction = torch.broadcast_tensors(source, direction)
    dist, hit, cells = march(free.to(torch.bool), source, direction, max_range, resolution,
                             steps)
    return (dist, hit, cells) if count_cells else (dist, hit)


def _strided_axes(shape, source: Tensor, direction: Tensor):
    """The broadcast shape as at most :data:`MAX_DIMS` axes with each
    input's strides in floats (size-1 axes dropped, adjacent axes merged
    where both inputs allow), or None where more remain."""
    axes = [(n, source.stride(d), direction.stride(d)) for d, n in enumerate(shape) if n != 1]
    merged: list = []
    for n, ss, ds in axes:
        if merged and merged[-1][1] == ss * n and merged[-1][2] == ds * n:
            m = merged.pop()
            merged.append((m[0] * n, ss, ds))
        else:
            merged.append((n, ss, ds))
    merged = merged or [(1, 0, 0)]
    return merged if len(merged) <= MAX_DIMS else None


def cast_rays(grid, source_xy_local: Tensor, dir_xy_local: Tensor, max_range: float,
              variant: str = "standard"):
    """Bresenham-march rays through ``grid``: kernel R1's ray entry.

    Args:
      grid: ``OccupancyGrid``.
      source_xy_local: ``f32[..., 2]`` ray sources in grid-local meters.
      dir_xy_local: ``f32[..., 2]`` unit directions (grid-local); the two
        broadcast against each other (the kernel reads them through their
        strides, so a broadcast is not copied).
      max_range: maximum ray length in meters; with the grid's resolution
        it sets the iteration count.
      variant: ``"standard"`` or ``"supercover"``.

    Returns ``(distance f32[...], hit bool[...])``.  On the card the kernel
    reads the grid's bit plane (:func:`free_plane`, packed at first use).
    """
    global launches
    if variant not in VARIANTS:
        raise ValueError(f"unknown Bresenham variant: {variant!r}")
    steps = num_steps(max_range, grid.resolution)
    source, direction = torch.broadcast_tensors(source_xy_local, dir_xy_local)
    device = grid.data.device
    for name, t in (("source_xy_local", source), ("dir_xy_local", direction)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the grid on {device}")
        if t.dtype != torch.float32 or t.shape[-1:] != (2,):
            raise ValueError(f"{name} must be float32[..., 2], got {t.dtype}{list(t.shape)}")
    if not on_card(device):
        return cast_rays_reference(grid.free_mask, source, direction, max_range,
                                   grid.resolution, steps, variant)
    shape = source.shape[:-1]
    n = math.prod(shape)
    if n >= 2**31:
        raise ValueError(f"{n} rays; the kernel takes fewer than 2^31")
    if source.stride(-1) != 1 or direction.stride(-1) != 1:
        source, direction = source.contiguous(), direction.contiguous()
    axes = _strided_axes(shape, source, direction)
    if axes is None:
        source, direction = source.contiguous(), direction.contiguous()
        axes = [(n, 2, 2)]
    sizes, src_strides, dir_strides = ((ctypes.c_longlong * len(axes))(*col)
                                       for col in zip(*axes))
    bits = free_plane(grid).bits
    dist = torch.empty(shape, dtype=torch.float32, device=device)
    hit = torch.empty(shape, dtype=torch.bool, device=device)
    stream = stream_ptr(device)
    _cast_rays(
        bits.data_ptr(), grid.height, grid.width, bits.shape[1], source.data_ptr(),
        direction.data_ptr(), len(axes), sizes, src_strides, dir_strides, n, float(max_range),
        float(grid.resolution), steps, VARIANTS.index(variant), dist.data_ptr(),
        hit.data_ptr(), stream)
    launches += 1
    return dist, hit


# -- the exact beam-weights entry ----------------------------------------------------


def ranges_and_bearings(points: Tensor) -> tuple[Tensor, Tensor]:
    """Measured range ``|p|`` and unit bearing ``p / max(|p|, 1e-12)`` of
    each beam (beam_model.hpp:116-121)."""
    px, py = points[..., 0], points[..., 1]
    z = torch.sqrt(px * px + py * py)
    return z, points / torch.clamp_min(z, 1e-12)[..., None]


def exact_pz3_reference(grid, states: SE2, points: Tensor, mix: Mixture, max_range: float,
                        variant: str = "standard") -> Tensor:
    """Every (particle, beam)'s ``pz³``, ``f32[..., N, nb]``, as the plain
    version of the exact entry computes it (beam.py:54-97)."""
    z, bearing = ranges_and_bearings(points)
    # ray sources and directions in the grid-local frame
    # (raycasting.hpp:62-71, 79-84)
    local = grid.origin.inverse() @ states  # [..., N]
    src = local.xy[..., :, None, :]  # [..., N, 1, 2]
    c, s = local.rot.cos[..., :, None], local.rot.sin[..., :, None]
    bx, by = bearing[..., None, :, 0], bearing[..., None, :, 1]
    direction = torch.stack([c * bx - s * by, s * bx + c * by], dim=-1)  # [..., N, nb, 2]
    dist, hit = cast_rays_reference(grid.free_mask, src, direction, max_range,
                                    grid.resolution, num_steps(max_range, grid.resolution),
                                    variant)
    z_mean = torch.where(hit, dist, mix.bmr)
    return mixture_pz3(z[..., None, :], z_mean, mix, erf=torch.erf)


def exact_beam_weights_reference(grid, states: SE2, points: Tensor, beam_mask: Tensor,
                                 mix: Mixture, max_range: float, variant: str = "standard",
                                 log_space: bool = False) -> Tensor:
    """Plain PyTorch version of the exact entry: the beam model's weights
    ``Σ_unmasked pz³`` per particle, ``f32[..., N]`` (beam.py:38-100), the
    beams added in order (:func:`masked_beam_sum`), or with ``log_space``
    ``log(max(w, 1e-30))``."""
    pz3 = exact_pz3_reference(grid, states, points, mix, max_range, variant)
    w = masked_beam_sum(pz3, beam_mask[..., None, :])
    return torch.log(torch.clamp_min(w, 1e-30)) if log_space else w


def exact_beam_weights(grid, states: SE2, points: Tensor, beam_mask: Tensor, mix: Mixture,
                       max_range: float, variant: str = "standard",
                       log_space: bool = False) -> Tensor:
    """The beam model's exact weights in one launch of kernel R1's exact
    entry on CUDA tensors, its plain version on CPU tensors.

    Args:
      grid: ``OccupancyGrid``; the kernel reads its bit plane
        (:func:`free_plane`, packed at first use).
      states: ``SE2`` particles ``[..., N]`` in the world frame.
      points: ``f32[..., nb, 2]`` scan endpoints in the base frame, one
        scan for each filter of the leading axes (or one for all).
      beam_mask: ``bool[..., nb]``.
      mix: the mixture's scalars (``models.sensor.beam.exact_mixture``).
      max_range: the beam max range in meters.
      variant: the Bresenham variant, ``"standard"`` or ``"supercover"``.
      log_space: return ``log(max(w, 1e-30))``.

    Returns ``f32[..., N]``.
    """
    global exact_launches
    if variant not in VARIANTS:
        raise ValueError(f"unknown Bresenham variant: {variant!r}")
    device = grid.data.device
    for name, t in (("states", states.xy), ("points", points), ("beam_mask", beam_mask)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the grid on {device}")
    if not on_card(device):
        return exact_beam_weights_reference(grid, states, points, beam_mask, mix, max_range,
                                            variant, log_space)
    lead, n = tuple(states.shape[:-1]), states.shape[-1]
    nb = points.shape[-2]
    filters = math.prod(lead)
    if filters > MAX_FILTERS:
        raise ValueError(f"{filters} filters; the kernel takes at most {MAX_FILTERS}")
    if points.dtype != torch.float32 or beam_mask.dtype != torch.bool:
        raise ValueError(f"points must be float32 and beam_mask bool, got {points.dtype}, "
                         f"{beam_mask.dtype}")
    # the kernel reads each state's pairs as float2
    xy, rot = (t.contiguous() if t.data_ptr() % 8 == 0 else t.clone()
               for t in (states.xy, states.rot.z))
    if xy.dtype != torch.float32 or rot.dtype != torch.float32:
        raise ValueError("states must be float32")
    pts = torch.broadcast_to(points, (*lead, nb, 2)).contiguous()
    mask = torch.broadcast_to(beam_mask, (*lead, nb)).contiguous()
    out = torch.empty((*lead, n), dtype=torch.float32, device=device)
    if n == 0 or filters == 0:
        return out
    plane = free_plane(grid)
    world = (ctypes.c_float * 4)(*plane.world_to_grid)
    scalars = (ctypes.c_float * len(mix))(*mix)
    stream = stream_ptr(device)
    _beam_exact(
        plane.bits.data_ptr(), grid.height, grid.width, plane.bits.shape[1], xy.data_ptr(),
        rot.data_ptr(), n, filters, world, pts.data_ptr(), mask.data_ptr(), nb,
        float(grid.resolution), float(max_range), num_steps(max_range, grid.resolution),
        VARIANTS.index(variant), int(log_space), scalars, out.data_ptr(), stream)
    exact_launches += 1
    return out
