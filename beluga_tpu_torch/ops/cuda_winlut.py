"""Kernel B6: the windowed pose-LUT lookup, bf16 and int8 tables.

Port of ``beluga_tpu/ops/pallas_winlut.py:winlut_lookup``
(``csrc/winlut.cu``).  :func:`winlut_lookup` launches the kernel on CUDA
tensors and runs :func:`winlut_lookup_reference`, the plain PyTorch
version, on CPU tensors.

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
import functools

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

MAX_PARTICLES = 2**31 - 1
INV127 = float(np.float32(1.0 / 127.0))  # the reference's scale * (1.0 / 127.0) in float32

# kernel launches since the count was last set to 0: bf16 tables, int8 tables
launches = 0
int8_launches = 0

_fns: dict = {}


def _kernel(int8: bool = False):
    name = "beluga_winlut_lookup_int8" if int8 else "beluga_winlut_lookup"
    fn = _fns.get(name)
    if fn is None:
        from beluga_tpu_torch.ops._build import load_library

        fn = getattr(load_library("winlut"), name)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, i, i, i, i, p, p, p, i, i, p, f] + ([p, f] if int8 else []) + [p, p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def floor_mod(a: Tensor, b: Tensor) -> Tensor:
    """``jnp.mod`` for a positive divisor ``b``: ``fmod``, plus ``b`` where
    the remainder is negative (``fmod`` keeps the dividend's sign)."""
    r = torch.fmod(a, b)
    return torch.where(r < 0, r + b, r)


def slab_bases(t: Tensor, k_bins: int, tblk: int, tile: int) -> Tensor:
    """Per-slot θ-slab base ``t_lo`` (float32) of slots ``t`` padded to
    whole tiles: the clamped floor of each tile's min ``t`` in ``[0, K)``."""
    tt = t.reshape(-1, tile)
    t_in = torch.where((tt >= 0.0) & (tt < k_bins), tt, torch.inf)
    t_lo = torch.clamp(torch.floor(torch.amin(t_in, dim=1)), 0.0, max(k_bins - tblk, 0))
    return t_lo[:, None].expand(-1, tile).reshape(-1)


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
    the kernel does not take), cached by them: ``(K, Wx, Wy, tblk)``."""
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
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    k, wx, wy = vshape
    return k, wx, wy, min(tblk, k)


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
    k, wx, wy, tb = _plan(_meta(values_t), _meta(xi), _meta(yi), _meta(t), tile, tblk,
                          scale is not None)
    if not values_t.is_cuda:
        return winlut_lookup_reference(values_t, xi, yi, t, miss, base, tile, tblk, scale)
    dev = values_t.device
    n = xi.shape[0]
    miss_ptr, _miss = _float_ptr(miss, dev)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = (values_t.data_ptr(), k, wx, wy, tb, xi.data_ptr(), yi.data_ptr(), t.data_ptr(), n,
            tile, miss_ptr, float(base))
    if scale is not None:
        scale_ptr, _scale = _float_ptr(scale, dev)
        err = _kernel(True)(*head, scale_ptr, INV127, out.data_ptr(), stream)
    else:
        err = _kernel()(*head, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"winlut kernel launch failed: cudaError {err}")
    if scale is not None:
        int8_launches += 1
    else:
        launches += 1
    return out
