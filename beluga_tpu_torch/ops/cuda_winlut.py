"""Kernel B6: the windowed pose-LUT lookup, bf16 and int8 tables.

Port of ``beluga_tpu/ops/pallas_winlut.py:winlut_lookup``
(``csrc/winlut.cu``), with three entries that share its device code:

* :func:`winlut_lookup`, from window coordinates (the counterpart of the
  reference's ``winlut_lookup``);
* :func:`winlut_lookup_states`, ``windowed_scan_lut_weights`` in one
  launch: the window coordinates of the SE2 states (``world_to_field @
  states``, then :func:`window_coords`' chain) computed in the kernel;
* :func:`winlut_coverage_states`, ``windowed_coverage_tiled_from_center``
  in one launch: the window origin about a cloud centre
  (:func:`window_origin`), the same coordinates and slab rule, and the share
  of the slots the lookup would score (:func:`tiled_coverage`), read no
  table; for one filter ``[N]`` or a fleet ``[B, N]`` (one share a filter,
  the winlut fleet's gate, still one launch).

Each launches its kernel on CUDA tensors and runs its plain PyTorch version
(:func:`winlut_lookup_reference`, :func:`winlut_lookup_states_reference`,
:func:`winlut_coverage_states_reference`) on CPU tensors.

Per particle it returns ``base + Σ_x tx·Σ_j wθ·Σ_y ty·L[t_lo + j, x, y]``
with tent weights ``max(1 - |c - i|, 0)``, or ``miss`` outside the window
or the tile's θ slab: slots come in tiles of ``tile``, each tile's slab
starts at ``t_lo = clip(floor(min of its t in [0, K)), 0, K - tblk)``, and
a particle is valid when ``0 <= xi <= Wx-1``, ``0 <= yi <= Wy-1`` and
``0 <= floor(t) - t_lo <= tblk - 2``.

Contract: the reference's interpret-mode semantics, float32 tents (on the
TPU the y tent was rounded to bf16 before the MXU product,
pallas_winlut.py:109-112; not here).  The kernel and the plain version
take the same float32 operations in the same order (y innermost, then θ,
then x), so they agree bit for bit; against the reference's dot products
the values agree to ~1e-6 relative and the miss sets are equal.
``dynamic_span`` only changed the TPU schedule and is not reproduced.

**int8 tables** (B6-int8, a table ``round(L / scale)`` with a per-build
``scale``) take the reference's int8 path (pallas_winlut.py:109-142): the y
tent is quantized to ``round_half_even(ty · 127)``, each slab's y sum is an
exact integer dot, ``acc = Σ_j wθ · f32(dot)``, then ``acc · (scale ·
f32(1/127))`` and the x tent.  The kernel and its plain version
(:func:`trilinear_int8_reference`) take the same operations in the same
order and agree bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from beluga_tpu_torch.lie import SE2
from beluga_tpu_torch.ops._build import Entry, stream_ptr, on_card

Tensor = torch.Tensor
F32 = torch.float32

MAX_PARTICLES = 2**31 - 1
MAX_STATES_TILE = 8192  # the states and coverage entries: eight slots a thread of 1024
MAX_FILTERS = 65535  # the coverage entry's filters: grid.y
INV127 = float(np.float32(1.0 / 127.0))  # the reference's scale * (1.0 / 127.0) in float32

# kernel launches since the count was last set to 0: the coordinates entry
# on bf16 and int8 tables, the states entry on each, the coverage entry
launches = 0
int8_launches = 0
states_launches = 0
int8_states_launches = 0
coverage_launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_lookup = Entry("winlut", "beluga_winlut_lookup",
                [_P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P, _F, _P, _P],
                "winlut kernel launch")
_lookup_int8 = Entry("winlut", "beluga_winlut_lookup_int8",
                     [_P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P, _F, _P, _F, _P, _P],
                     "winlut kernel launch")
_lookup_states = Entry("winlut", "beluga_winlut_lookup_states",
                       [_P, _I, _I, _I, _I, _I, _P, _P, _I, _I, _P, _P, _F, _I, _P, _P, _P, _F,
                        _F, _F, _P, _F, _P, _F, _P, _P],
                       "winlut states kernel launch")
_coverage_states = Entry("winlut", "beluga_winlut_coverage_states",
                         [_I, _I, _I, _I, _P, _P, _I, _I, _I, _P, _P, _F, _I, _I, _I, _P, _P, _P,
                          _F, _F, _F, _F, _P, _P, _P],
                         "winlut coverage kernel launch")


def floor_mod(a: Tensor, b: Tensor) -> Tensor:
    """``jnp.mod`` for a positive divisor ``b``: ``fmod``, plus ``b`` where
    the remainder is negative (``fmod`` keeps the dividend's sign)."""
    r = torch.fmod(a, b)
    return torch.where(r < 0, r + b, r)


def slab_bases(t: Tensor, k_bins: int, tblk: int, tile: int) -> Tensor:
    """Per-slot θ-slab base ``t_lo`` (float32) of slots ``t`` ``[..., N]``
    padded to whole tiles of each filter: the clamped floor of each tile's
    min ``t`` in ``[0, K)``."""
    tt = t.reshape(-1, tile)
    t_in = torch.where((tt >= 0.0) & (tt < k_bins), tt, torch.inf)
    t_lo = torch.clamp(torch.floor(torch.amin(t_in, dim=1)), 0.0, max(k_bins - tblk, 0))
    return t_lo[:, None].expand(-1, tile).reshape(t.shape)


def _tent(c: Tensor, i: Tensor) -> Tensor:
    return torch.clamp_min(1.0 - torch.abs(c - i), 0.0)


def trilinear_reference(values_t: Tensor, xf: Tensor, yf: Tensor, t: Tensor, t_lo: Tensor,
                        tblk: int, miss, base) -> Tensor:
    """``base`` + the trilinear slab lookup of each particle, or ``miss``:
    the eight table reads of the kernel's ``trilinear``, in its order."""
    _, wx, wy = values_t.shape
    k0rel = torch.floor(t) - t_lo
    valid = ((xf >= 0.0) & (xf <= wx - 1) & (yf >= 0.0) & (yf <= wy - 1)
             & (k0rel >= 0.0) & (k0rel <= tblk - 2))
    u = t - t_lo
    x0f, y0f = torch.floor(xf), torch.floor(yf)
    zero = torch.zeros((), dtype=torch.float32, device=xf.device)
    ix = torch.where(valid, x0f, zero).long()
    iy = torch.where(valid, y0f, zero).long()
    jt = torch.where(valid, t_lo + k0rel, zero).long()
    ix1, iy1 = torch.clamp_max(ix + 1, wx - 1), torch.clamp_max(iy + 1, wy - 1)
    flat = values_t.reshape(-1)

    def read(j, x, y):
        return flat[(j * wx + x) * wy + y].float()

    ty0, ty1 = _tent(yf, y0f), _tent(yf, y0f + 1.0)
    tt0, tt1 = _tent(u, k0rel), _tent(u, k0rel + 1.0)
    tx0, tx1 = _tent(xf, x0f), _tent(xf, x0f + 1.0)

    def along_y(j, x):
        return ty0 * read(j, x, iy) + ty1 * read(j, x, iy1)

    def along_theta(x):
        return tt0 * along_y(jt, x) + tt1 * along_y(jt + 1, x)

    val = tx0 * along_theta(ix) + tx1 * along_theta(ix1)
    return torch.where(valid, base + val, miss)


def trilinear_int8_reference(values_t: Tensor, xf: Tensor, yf: Tensor, t: Tensor,
                             t_lo: Tensor, tblk: int, miss, base, scale) -> Tensor:
    """:func:`trilinear_reference` over an int8 table in the reference's
    int8 arithmetic: integer y dots with the quantized y tent, the θ lerp,
    ``· (scale · f32(1/127))``, then the x lerp."""
    _, wx, wy = values_t.shape
    dev = xf.device
    k0rel = torch.floor(t) - t_lo
    valid = ((xf >= 0.0) & (xf <= wx - 1) & (yf >= 0.0) & (yf <= wy - 1)
             & (k0rel >= 0.0) & (k0rel <= tblk - 2))
    u = t - t_lo
    x0f, y0f = torch.floor(xf), torch.floor(yf)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    ix = torch.where(valid, x0f, zero).long()
    iy = torch.where(valid, y0f, zero).long()
    jt = torch.where(valid, t_lo + k0rel, zero).long()
    ix1, iy1 = torch.clamp_max(ix + 1, wx - 1), torch.clamp_max(iy + 1, wy - 1)
    flat = values_t.reshape(-1)
    q0 = torch.round(_tent(yf, y0f) * 127.0).to(torch.int32)
    q1 = torch.round(_tent(yf, y0f + 1.0) * 127.0).to(torch.int32)
    tt0, tt1 = _tent(u, k0rel), _tent(u, k0rel + 1.0)
    tx0, tx1 = _tent(xf, x0f), _tent(xf, x0f + 1.0)
    step = torch.as_tensor(scale, dtype=torch.float32, device=dev) * torch.tensor(
        INV127, dtype=torch.float32, device=dev)

    def dot(j, x):
        row = (j * wx + x) * wy
        return (flat[row + iy].to(torch.int32) * q0 + flat[row + iy1].to(torch.int32) * q1).float()

    def along_theta(x):
        return (tt0 * dot(jt, x) + tt1 * dot(jt + 1, x)) * step

    val = tx0 * along_theta(ix) + tx1 * along_theta(ix1)
    return torch.where(valid, base + val, miss)


def winlut_lookup_reference(values_t: Tensor, xi: Tensor, yi: Tensor, t: Tensor, miss,
                            base: float = 1.0, tile: int = 512, tblk: int = 16,
                            scale=None) -> Tensor:
    """Plain PyTorch version of kernel B6: the tile reshape, the per-tile
    minimum and the eight reads (int8 tables with their ``scale``)."""
    k = values_t.shape[0]
    tblk = min(tblk, k)
    n = xi.shape[0]
    n_pad = -(-n // tile) * tile
    t_lo = slab_bases(F.pad(t, (0, n_pad - n), value=-1.0), k, tblk, tile)[:n]
    if values_t.dtype == torch.int8:
        return trilinear_int8_reference(values_t, xi, yi, t, t_lo, tblk, miss, base, scale)
    return trilinear_reference(values_t, xi, yi, t, t_lo, tblk, miss, base)


def _meta(t: Tensor) -> tuple:
    """What the checks read of a tensor: shape, dtype, device, contiguity."""
    return t.shape, t.dtype, t.device, t.is_contiguous()


@functools.lru_cache(maxsize=64)
def _plan(values_t, xi, yi, t, tile, tblk, has_scale) -> tuple:
    """The wrapper's checks on its tensors' :func:`_meta` (raising on what
    the kernel does not take), cached by them: ``(K, Wx, Wy, tblk, whether
    the kernel runs)``."""
    (vshape, vdtype, device, _), n = values_t, xi[0][0] if len(xi[0]) == 1 else -1
    if vdtype not in (torch.bfloat16, torch.int8) or len(vshape) != 3:
        raise ValueError(f"values_t must be bfloat16 or int8 [K, Wx, Wy], got "
                         f"{vdtype}{list(vshape)}")
    if (vdtype == torch.int8) != has_scale:
        raise ValueError("an int8 table needs its scale, and only an int8 table takes one")
    for name, (shape, dtype, dev, contiguous) in (("values_t", values_t), ("xi", xi), ("yi", yi),
                                                 ("t", t)):
        if dev != device:
            raise ValueError(f"{name} is on {dev}, values_t on {device}")
        if not contiguous:
            raise ValueError(f"{name} must be contiguous")
        if name != "values_t" and (dtype != torch.float32 or tuple(shape) != (n,)):
            raise ValueError(f"{name} must be float32[N] like xi, got {dtype}{list(shape)}")
    if n > MAX_PARTICLES:
        raise ValueError(f"{n} particles; the kernel takes at most {MAX_PARTICLES}")
    if tile < 1 or tblk < 1:
        raise ValueError(f"tile and tblk must be positive, got {tile}, {tblk}")
    kernel = on_card(device)
    k, wx, wy = vshape
    return k, wx, wy, min(tblk, k), kernel


@functools.lru_cache(maxsize=64)
def _device_float(value: float, device: torch.device) -> Tensor:
    """A host float as a float32 [1] on the device, made once."""
    return torch.tensor([value], dtype=torch.float32, device=device)


def _float_ptr(v, device: torch.device) -> tuple[int, Tensor]:
    """The device address of a float32 scalar ``v`` (a float or a 0-d or
    one-element tensor) and the tensor that holds it: ``v`` itself when it
    already lies on the device as float32, else a copy."""
    if isinstance(v, Tensor):
        if v.device != device or v.dtype != torch.float32 or v.numel() != 1:
            v = torch.as_tensor(v, dtype=torch.float32, device=device).reshape(1)
    else:
        v = _device_float(float(v), device)
    return v.data_ptr(), v


def winlut_lookup(values_t: Tensor, xi: Tensor, yi: Tensor, t: Tensor, miss,
                  base: float = 1.0, tile: int = 512, tblk: int = 16, scale=None) -> Tensor:
    """Evaluate ``base + lerp_θ(L[t, xi, yi])`` per particle, ``f32[N]``.

    Args:
      values_t: ``bf16[K, Wx, Wy]`` x-major windowed LUT, or its int8
        quantization (entry · ``scale`` is the value).
      xi, yi: ``f32[N]`` fractional window cells; t: ``f32[N]`` fractional
        θ bins.  Slots should be θ-sorted so that a tile spans at most
        ``tblk - 1`` bins; particles above their tile's slab score miss.
      miss: replacement weight outside (a float or a 0-d tensor, which may
        live on the device); base: additive base (1.0 for ``1 + Σ pz³``).
      tile: slots per tile; tblk: θ-slab depth (clipped to K).
      scale: an int8 table's quantization step (a float or a 0-d tensor,
        which may live on the device); None for a bf16 table.

    The checks and the launch geometry are cached by the tensors' shapes,
    dtypes, devices and contiguity; a device scalar is passed by address.
    """
    global launches, int8_launches
    k, wx, wy, tb, kernel = _plan(_meta(values_t), _meta(xi), _meta(yi), _meta(t), tile, tblk,
                                  scale is not None)
    if not kernel:
        return winlut_lookup_reference(values_t, xi, yi, t, miss, base, tile, tblk, scale)
    dev = values_t.device
    n = xi.shape[0]
    miss_ptr, _miss = _float_ptr(miss, dev)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    stream = stream_ptr(dev)
    head = (values_t.data_ptr(), k, wx, wy, tb, xi.data_ptr(), yi.data_ptr(), t.data_ptr(), n,
            tile, miss_ptr, float(base))
    if scale is not None:
        scale_ptr, _scale = _float_ptr(scale, dev)
        _lookup_int8(*head, scale_ptr, INV127, out.data_ptr(), stream)
        int8_launches += 1
    else:
        _lookup(*head, out.data_ptr(), stream)
        launches += 1
    return out


# -- the window coordinates, origin and coverage (plain PyTorch) ---------------


def _f32(v, device) -> Tensor:
    """``v`` as a float32 0-d tensor on ``device``, made by a fill on the
    card (``torch.tensor(v, device=cuda)`` would be a copy that waits on
    the stream)."""
    return torch.full((), v, dtype=F32, device=device)


@dataclasses.dataclass(frozen=True)
class WindowGeometry:
    """What the window's placement reads of a likelihood field: its
    ``world_to_field`` (``SE2``, ``xy`` and ``rot.z`` ``f32[2]`` on the
    field's device), its float32 ``resolution`` as a float, the ``pad`` band
    and the padded image's ``hp`` rows and ``wp`` columns, and the window's
    ``k_bins`` heading bins of ``dth`` over ``win_x`` x ``win_y`` cells."""

    world_to_field: SE2
    resolution: float
    pad: int
    hp: int
    wp: int
    k_bins: int
    win_x: int
    win_y: int
    dth: float


def window_origin(geo: WindowGeometry, center_x, center_y, center_theta):
    """The window origin ``(x0, y0, theta0)`` about a cloud centre (world
    frame, 0-d tensors on the field's device; winlut.py:142-184): the
    centre's cell through ``floor(x / res)`` in int32 plus the pad, the
    origin clamped so that the scan-radius ring around the window stays
    inside the padded image, the heading grid anchored at multiples of
    ``dth``.  ``x0``/``y0`` int64 and ``theta0`` float32 0-d tensors."""
    dev = geo.world_to_field.xy.device
    res = _f32(geo.resolution, dev)
    tf = geo.world_to_field @ SE2.from_xytheta(center_x, center_y, center_theta, device=dev)
    cx = torch.floor(tf.x / res).to(torch.int32).to(torch.int64) + geo.pad
    cy = torch.floor(tf.y / res).to(torch.int32).to(torch.int64) + geo.pad
    x0 = torch.clamp(cx - geo.win_x // 2, geo.pad, geo.wp - geo.win_x - geo.pad)
    y0 = torch.clamp(cy - geo.win_y // 2, geo.pad, geo.hp - geo.win_y - geo.pad)
    dth_t = _f32(geo.dth, dev)
    theta0 = (torch.floor(tf.theta / dth_t) - (geo.k_bins // 2)) * dth_t
    return x0, y0, theta0


def window_coords(world_to_field: SE2, resolution: float, pad: int, x0: Tensor, y0: Tensor,
                  theta0: Tensor, k_bins: int, dth: float, states: SE2):
    """Fractional ``(xi, yi, t)`` window coordinates (winlut.py:293-304): the
    -0.5 aligns the sinc-built point samples with the exact model's
    floor-cell convention."""
    dev = states.xy.device
    tf = world_to_field @ states
    res = _f32(resolution, dev)
    xi = tf.x / res - 0.5 + (pad - x0).to(F32)
    yi = tf.y / res - 0.5 + (pad - y0).to(F32)
    center = theta0 + _f32((k_bins // 2) * dth, dev)
    pi = _f32(math.pi, dev)
    rel = floor_mod(tf.theta - center + pi, _f32(2.0 * math.pi, dev)) - pi
    t = rel / _f32(dth, dev) + (k_bins // 2)
    return xi, yi, t


def tiled_coverage(xi: Tensor, yi: Tensor, t: Tensor, k_bins: int, win_x: int, win_y: int,
                   tile: int, tblk: int) -> Tensor:
    """Fraction of particles the lookup scores, the per-tile θ slab
    included (winlut.py:350-385): each ``tile`` of slots gets a slab of
    ``tblk`` bins based at the clamped floor of its min valid ``t``, and
    particles above the slab score miss.  Coordinates ``[..., N]`` give
    one fraction a filter, ``[...]``, each filter's slots in tiles of its
    own."""
    tblk = min(tblk, k_bins)
    n = xi.shape[-1]
    n_pad = -(-n // tile) * tile
    xi_p, yi_p, t_p = (F.pad(v, (0, n_pad - n), value=-1.0) for v in (xi, yi, t))
    k0rel = torch.floor(t_p) - slab_bases(t_p, k_bins, tblk, tile)
    ok = ((xi_p >= 0) & (xi_p <= win_x - 1) & (yi_p >= 0) & (yi_p <= win_y - 1)
          & (k0rel >= 0.0) & (k0rel <= tblk - 2))
    return torch.sum(ok.to(F32), dim=-1) / n


# -- the states entry and the coverage entry -----------------------------------


def winlut_lookup_states_reference(lut, states: SE2, miss, base: float = 1.0, tile: int = 512,
                                   tblk: int = 16) -> Tensor:
    """Plain PyTorch version of the states entry: :func:`window_coords` of
    the states in ``lut``'s window, then :func:`winlut_lookup_reference`."""
    xi, yi, t = window_coords(lut.world_to_field, lut.resolution, lut.pad_cells, lut.x0, lut.y0,
                              lut.theta0, lut.k_bins, lut.dth, states)
    return winlut_lookup_reference(lut.values_t, xi, yi, t, miss, base, tile, tblk, lut.scale)


def winlut_coverage_states_reference(geo: WindowGeometry, states: SE2, center_x, center_y,
                                     center_theta, tile: int = 512, tblk: int = 16) -> Tensor:
    """Plain PyTorch version of the coverage entry: :func:`window_origin`,
    :func:`window_coords`, :func:`tiled_coverage`."""
    x0, y0, theta0 = window_origin(geo, center_x, center_y, center_theta)
    xi, yi, t = window_coords(geo.world_to_field, geo.resolution, geo.pad, x0, y0, theta0,
                              geo.k_bins, geo.dth, states)
    return tiled_coverage(xi, yi, t, geo.k_bins, geo.win_x, geo.win_y, tile, tblk)


@functools.lru_cache(maxsize=64)
def _states_plan(states, field, scalars, tile: int, tblk: int,
                 fleet: bool = False) -> tuple[int, bool]:
    """The states and coverage entries' checks on their tensors' ``_meta``
    (raising on what the kernels do not take), cached by them: ``n``, the
    states a filter, and whether the kernel runs.  ``states`` holds the
    states' xy and rot (``[N, 2]``, or with ``fleet`` also ``[B, N, 2]``),
    ``field`` world_to_field's xy and rot, ``scalars`` the device scalars
    each entry reads by address (name, meta, dtype)."""
    (xshape, _, device, _), _ = states
    dims = (2, 3) if fleet else (2,)
    for name, (shape, dtype, dev, contiguous) in zip(("states.xy", "states.rot"), states):
        if dev != device:
            raise ValueError(f"{name} is on {dev}, states.xy on {device}")
        if not contiguous:
            raise ValueError(f"{name} must be contiguous")
        if dtype != torch.float32 or len(shape) not in dims or shape[-1] != 2 or shape != xshape:
            raise ValueError(f"{name} must be float32[N, 2]{' or [B, N, 2]' if fleet else ''}"
                             f" like states.xy, got {dtype}{list(shape)}")
    if len(xshape) == 3 and not 0 < xshape[0] <= MAX_FILTERS:
        raise ValueError(f"{xshape[0]} filters; the kernel takes 1 to {MAX_FILTERS}")
    for name, (shape, dtype, dev, _) in zip(("world_to_field.xy", "world_to_field.rot"), field):
        if dev != device or dtype != torch.float32 or tuple(shape) != (2,):
            raise ValueError(f"{name} must be float32[2] on {device}, got {dtype}{list(shape)} "
                             f"on {dev}")
    for name, (shape, dtype, dev, _), want in scalars:
        if dev != device or dtype != want or math.prod(shape) != 1:
            raise ValueError(f"{name} must be one {want} on {device}, got {dtype}{list(shape)} "
                             f"on {dev}")
    kernel = on_card(device)
    n = xshape[-2]
    if math.prod(xshape[:-1]) > MAX_PARTICLES:
        raise ValueError(f"{n} particles; the kernel takes at most {MAX_PARTICLES}")
    if tile < 1 or tblk < 1:
        raise ValueError(f"tile and tblk must be positive, got {tile}, {tblk}")
    if kernel and not 0 < n:
        raise ValueError("the kernel takes at least one particle")
    if kernel and tile > MAX_STATES_TILE:
        raise ValueError(f"tile {tile}; the kernel takes at most {MAX_STATES_TILE}")
    return n, kernel


def _frame_floats(k_bins: int, dth: float, resolution: float) -> tuple[float, float, float, float]:
    """The host floats of the coordinate chain, as the plain version's
    float32 tensors hold them: the resolution, f32((K // 2)·dth), f32(dth)
    and K // 2."""
    f32 = np.float32
    return (float(f32(resolution)), float(f32((k_bins // 2) * dth)), float(f32(dth)),
            float(k_bins // 2))


@functools.lru_cache(maxsize=64)
def _table_plan(values_t, has_scale: bool, device) -> tuple[int, int, int]:
    """The states entry's checks of its table's ``_meta``: ``(K, Wx, Wy)``."""
    vshape, vdtype, vdev, contiguous = values_t
    if vdtype not in (torch.bfloat16, torch.int8) or len(vshape) != 3:
        raise ValueError(f"values_t must be bfloat16 or int8 [K, Wx, Wy], got "
                         f"{vdtype}{list(vshape)}")
    if (vdtype == torch.int8) != has_scale:
        raise ValueError("an int8 table needs its scale, and only an int8 table takes one")
    if vdev != device:
        raise ValueError(f"values_t is on {vdev}, the states on {device}")
    if not contiguous:
        raise ValueError("values_t must be contiguous")
    return tuple(vshape)


def winlut_lookup_states(lut, states: SE2, miss, base: float = 1.0, tile: int = 512,
                         tblk: int = 16) -> Tensor:
    """``windowed_scan_lut_weights`` in one launch: :func:`winlut_lookup` at
    the window coordinates of ``states`` in ``lut``'s window, computed in the
    kernel in the plain chain's order (``lie.py``'s composition, the
    divisions by the resolution and the bin width as IEEE divisions), so
    that the cells, and so the miss set, are the plain version's.

    Args:
      lut: a ``WindowedScanLut`` (``models/sensor/likelihood_field_winlut.py``):
        its table (bf16, or int8 with its ``scale``), origin ``x0``/``y0``
        (int64) and ``theta0`` (float32) are read on the device by address.
      states: ``SE2`` particles, ``xy`` and ``rot.z`` ``f32[N, 2]``,
        contiguous.
      miss, base, tile, tblk: as :func:`winlut_lookup` (tile at most 8192
        on the card).
    """
    global states_launches, int8_states_launches
    wf = lut.world_to_field
    scalars = (("lut.x0", _meta(lut.x0), torch.int64), ("lut.y0", _meta(lut.y0), torch.int64),
               ("lut.theta0", _meta(lut.theta0), torch.float32))
    n, kernel = _states_plan((_meta(states.xy), _meta(states.rot.z)),
                             (_meta(wf.xy), _meta(wf.rot.z)), scalars, tile, tblk)
    k, wx, wy = _table_plan(_meta(lut.values_t), lut.scale is not None, states.xy.device)
    if not kernel:
        return winlut_lookup_states_reference(lut, states, miss, base, tile, tblk)
    dev = states.xy.device
    int8 = lut.scale is not None
    miss_ptr, _miss = _float_ptr(miss, dev)
    scale_ptr, _scale = _float_ptr(lut.scale, dev) if int8 else (None, None)
    res, half_span, dth, half = _frame_floats(lut.k_bins, lut.dth, lut.resolution)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    _lookup_states(
        lut.values_t.data_ptr(), int(int8), k, wx, wy, min(tblk, k), states.xy.data_ptr(),
        states.rot.z.data_ptr(), n, tile, wf.xy.data_ptr(), wf.rot.z.data_ptr(), res,
        lut.pad_cells, lut.x0.data_ptr(), lut.y0.data_ptr(), lut.theta0.data_ptr(), half_span,
        dth, half, miss_ptr, float(base), scale_ptr, INV127, out.data_ptr(), stream_ptr(dev))
    if int8:
        int8_states_launches += 1
    else:
        states_launches += 1
    return out


_scratch: dict = {}  # the coverage entry's count by (device, stream handle)


def winlut_coverage_states(geo: WindowGeometry, states: SE2, center_x, center_y,
                           center_theta, tile: int = 512, tblk: int = 16) -> Tensor:
    """``windowed_coverage_tiled_from_center`` in one launch: the share of
    ``states`` that :func:`winlut_lookup_states` would score in the window
    that would be built about the centre, a 0-d float32 tensor; for a
    fleet's states ``[B, N]``, each filter's share ``f32[B]`` (its slots in
    tiles of its own) in the same launch.

    The kernel places the window as :func:`window_origin` does (the
    geometry computed once a block from the centre's device scalars), takes
    each state's coordinates as the states entry does, each tile's slab,
    and counts the slots inside: by ballot a warp, one atomic a block; the
    last block writes ``count · f32(1/n)``, which is the plain version's
    ``sum / n`` on the card (PyTorch's CUDA division by a number multiplies
    by its reciprocal; the float32 sum of the 0/1 flags is the exact count
    below 2²⁴).  The counts live in ``B + 1`` int32 of device scratch a
    (device, stream), zero between calls: the calls on one stream run one
    after another.  (A launch that faults part way leaves it wrong, but
    such a fault leaves the device's context unusable for every later call.)

    Args:
      geo: the field's :class:`WindowGeometry`.
      states: ``SE2`` particles, ``xy`` and ``rot.z`` ``f32[N, 2]`` or
        ``f32[B, N, 2]``, contiguous.
      center_x, center_y, center_theta: the centre, one float32 each on the
        states' device (read by address on the card).
      tile, tblk: as :func:`winlut_lookup` (tile at most 8192 on the card).
    """
    global coverage_launches
    wf = geo.world_to_field
    tensors = (_meta(states.xy), _meta(states.rot.z)), (_meta(wf.xy), _meta(wf.rot.z))
    n, kernel = _states_plan(*tensors, (), tile, tblk, True)
    if not kernel:  # the plain version takes the centre as host floats too
        return winlut_coverage_states_reference(geo, states, center_x, center_y, center_theta,
                                                tile, tblk)
    scalars = tuple((name, _meta(v) if isinstance(v, Tensor) else ((), type(v), None, True),
                     torch.float32)
                    for name, v in (("center_x", center_x), ("center_y", center_y),
                                    ("center_theta", center_theta)))
    _states_plan(*tensors, scalars, tile, tblk, True)
    dev = states.xy.device
    lead = tuple(states.xy.shape[:-2])
    filters = math.prod(lead)
    stream = stream_ptr(dev)
    scratch = _scratch.get((dev, stream))
    if scratch is None or scratch.numel() < filters + 1:
        scratch = _scratch[dev, stream] = torch.zeros(filters + 1, dtype=torch.int32,
                                                      device=dev)
    res, half_span, dth, half = _frame_floats(geo.k_bins, geo.dth, geo.resolution)
    out = torch.empty(lead, dtype=torch.float32, device=dev)
    _coverage_states(
        geo.k_bins, geo.win_x, geo.win_y, min(tblk, geo.k_bins), states.xy.data_ptr(),
        states.rot.z.data_ptr(), filters, n, tile, wf.xy.data_ptr(), wf.rot.z.data_ptr(), res,
        geo.pad, geo.wp, geo.hp, center_x.data_ptr(), center_y.data_ptr(),
        center_theta.data_ptr(), half_span, dth, half, float(np.float32(1.0) / np.float32(n)),
        scratch.data_ptr(), out.data_ptr(), stream)
    coverage_launches += 1
    return out

