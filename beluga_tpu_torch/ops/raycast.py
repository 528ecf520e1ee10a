"""Ray casting over an occupancy grid with Bresenham parity (port of
``beluga_tpu/ops/raycast.py``), and kernel R1.

:func:`cast_rays` launches kernel R1 (``csrc/raycast.cu``, one thread per
ray that stops at its first blocked cell) on CUDA tensors and runs
:func:`cast_rays_reference`, the plain PyTorch version, on CPU tensors.
The plain version is the reference's lock-step march written out: every
ray carries its own integer Bresenham state through ``ceil(max_range /
res) + 2`` iterations; every 16 iterations the finished rays are written
out and dropped, and the loop stops once none is left (``done`` freezes
the reference's carry, so neither changes a result).

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
through a reciprocal).  Against the JAX package the cells agree on the
same directions; a distance may differ by an ulp of ``hypot``, two after
the product with the resolution.
"""

from __future__ import annotations

import ctypes
import math

import torch

Tensor = torch.Tensor

VARIANTS = ("standard", "supercover")

# kernel launches since the count was last set to 0
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from beluga_tpu_torch.ops._build import load_library

        fn = load_library("raycast").beluga_cast_rays
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, i, i, p, p, ctypes.c_int64, f, f, i, i, p, p, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


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
    done flags, and the rays' own integer state in ``rays``.  Every 16
    iterations :meth:`settle` writes the finished rays out and drops them
    from the carry, which changes no result (``done`` freezes a ray)."""

    def __init__(self, free: Tensor, n: int, max_range: float, resolution: float, device,
                 rays: dict):
        self.free = free.reshape(-1)
        self.h, self.w = free.shape
        self.res = torch.full((), resolution, dtype=torch.float32, device=device)
        self.max_range = torch.full((), max_range, dtype=torch.float32, device=device)
        self.out_dist = torch.full((n,), max_range, dtype=torch.float32, device=device)
        self.out_hit = torch.zeros(n, dtype=torch.bool, device=device)
        self.ids = torch.arange(n, device=device)
        self.dist = self.out_dist.clone()
        self.hit = self.out_hit.clone()
        self.done = torch.zeros(n, dtype=torch.bool, device=device)
        self.rays = rays

    def probe(self, x: Tensor, y: Tensor, da: Tensor, db: Tensor, cond: Tensor | None) -> None:
        """Check cells ``(x, y)`` where ``cond`` and not done: latch a hit
        at the centroid distance of ``(da, db)`` cells, or a miss outside."""
        inside = (x >= 0) & (x < self.w) & (y >= 0) & (y < self.h)
        idx = torch.clamp(y, 0, self.h - 1).long() * self.w + torch.clamp(x, 0, self.w - 1).long()
        active = ~self.done if cond is None else cond & ~self.done
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
        keep = ~fin
        self.ids, self.dist, self.hit, self.done = (v[keep] for v in (self.ids, self.dist,
                                                                     self.hit, self.done))
        self.rays = {k: v[keep] for k, v in self.rays.items()}
        return self.ids.numel() == 0

    def result(self, shape):
        self.out_dist[self.ids] = self.dist
        self.out_hit[self.ids] = self.hit
        return self.out_dist.reshape(shape), self.out_hit.reshape(shape)


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
                        resolution: float, steps: int, variant: str = "standard"):
    """Plain PyTorch version of kernel R1 on a ``bool[H, W]`` free mask:
    ``(dist f32[...], hit bool[...])``."""
    march = _supercover if variant == "supercover" else _standard
    return march(free.to(torch.bool), source, direction, max_range, resolution, steps)


def cast_rays(grid, source_xy_local: Tensor, dir_xy_local: Tensor, max_range: float,
              variant: str = "standard"):
    """Bresenham-march rays through ``grid``.

    Args:
      grid: ``OccupancyGrid``.
      source_xy_local: ``f32[..., 2]`` ray sources in grid-local meters.
      dir_xy_local: ``f32[..., 2]`` unit directions (grid-local); the two
        broadcast against each other.
      max_range: maximum ray length in meters; with the grid's resolution
        it sets the iteration count.
      variant: ``"standard"`` or ``"supercover"``.

    Returns ``(distance f32[...], hit bool[...])``.
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
    if device.type == "cpu":
        return cast_rays_reference(grid.free_mask, source, direction, max_range,
                                   grid.resolution, steps, variant)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    shape = source.shape[:-1]
    n = math.prod(shape)
    free = grid.free_mask.to(torch.uint8).contiguous()
    src = source.reshape(-1, 2).contiguous()
    dirs = direction.reshape(-1, 2).contiguous()
    dist = torch.empty(shape, dtype=torch.float32, device=device)
    hit = torch.empty(shape, dtype=torch.bool, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _kernel()(free.data_ptr(), grid.height, grid.width, src.data_ptr(), dirs.data_ptr(),
                    n, float(max_range), float(grid.resolution), steps, VARIANTS.index(variant),
                    dist.data_ptr(), hit.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"raycast kernel launch failed: cudaError {err}")
    launches += 1
    return dist, hit
