"""Kernel B5: the fused particle forward pass, diff-drive sample + window
coordinates + θ-slab trilinear lookup + log.

Port of ``beluga_tpu/ops/pallas_fused_step.py:fused_propagate_winlut`` and
``pack_scalars`` (``csrc/winlut.cu``, beside kernel B6, whose slab minimum
and lookup it shares).  The kernel crosses global memory once a particle:
a persistent grid whose threads keep their slots in registers across each
tile's slab minimum, the table in shared memory when it fits (the mega
filter's 160 KB; a larger one is read through L2), the next tile's inputs
in flight while the current tile finishes.  :func:`fused_propagate_winlut`
launches the kernel on CUDA tensors and runs
:func:`fused_propagate_winlut_reference`, the plain PyTorch version, on CPU
tensors.

Per particle: ``rot1/trans/rot2 = mean + sd·z``; ``th1 = θ + rot1``,
``x' = x + trans·cos th1``, ``y' = y + trans·sin th1``, ``th2 = th1 +
rot2``; the window coordinates by the field-frame affine and ``t =
(jnp.mod(th2 + T_ANG + π, 2π) - π)·inv_dth + t_bias``; B6's slab and
lookup; ``log(max(w, 1e-30))``.  Returns ``(x', y', cos th2, sin th2,
log_lik)``, each ``f32[N]``.

* The 18 scalars are a device ``f32[18]`` tensor that the kernel reads, not
  launch arguments: the window origin is a device value, and passing it as
  an argument would read it back every update.
* Slots pad to whole tiles with 1.0 in every input (pallas_fused_step.py:
  198-202), and padded lanes take part in the last tile's slab minimum, so
  the result does not depend on whether ``N % tile == 0``.
* ``jnp.mod`` is ``fmod`` plus the divisor where the remainder is negative.
* The kernel writes the coordinate chain with round-to-nearest intrinsics,
  which nvcc never contracts into FMAs, so that it and the plain version
  agree on validity at window edges.

``kernel_prng=True`` (the TPU's in-kernel generator) is not ported: the
normals stay an input (ROADMAP, RNG rule).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from beluga_tpu_torch.ops._build import Entry, stream_ptr, on_card
from beluga_tpu_torch.ops.cuda_winlut import (
    MAX_PARTICLES,
    floor_mod,
    slab_bases,
    trilinear_reference,
)

Tensor = torch.Tensor

# scalar layout (pallas_fused_step.py:50-52)
NUM_SCALARS = 18
(R1_MU, R1_SD, T_MU, T_SD, R2_MU, R2_SD,
 WF_C, WF_S, WF_X, WF_Y, INV_RES, OFF_X, OFF_Y,
 T_ANG, INV_DTH, T_BIAS, MISS, BASE) = range(NUM_SCALARS)

MAX_TILE = 8192  # slots a tile: eight a thread of a 1024-thread block

# kernel launches since the count was last set to 0
launches = 0

_p, _i = ctypes.c_void_p, ctypes.c_int
_fused_step = Entry("winlut", "beluga_fused_step",
                    [_p, _p, _p, _p, _i, _p, _i, _i, _i, _i, _i, _p, _p, _p, _p, _p, _p, _p],
                    "fused step kernel launch")


def pack_scalars(r1_mu, r1_sd, t_mu, t_sd, r2_mu, r2_sd, world_to_field, inv_res, off_x,
                 off_y, t_ang, inv_dth, t_bias, miss, base, device) -> Tensor:
    """The per-update scalars as one ``f32[18]`` tensor on ``device``.
    Each value is a float, a host tensor or a 0-d tensor on ``device``;
    the host values cross in one copy, and nothing is read back."""
    device = torch.device(device)
    wf = world_to_field
    vals = [r1_mu, r1_sd, t_mu, t_sd, r2_mu, r2_sd, wf.rot.cos, wf.rot.sin, wf.x, wf.y,
            inv_res, off_x, off_y, t_ang, inv_dth, t_bias, miss, base]

    def on_device(v):  # already on the card: no copy, no readback
        return isinstance(v, Tensor) and v.device.type != "cpu"

    host = [torch.as_tensor(v, dtype=torch.float32).reshape(()) for v in vals
            if not on_device(v)]
    host = iter(torch.stack(host).to(device).unbind() if host else ())
    return torch.stack([v.to(device, torch.float32).reshape(()) if on_device(v) else next(host)
                        for v in vals])


def fused_propagate_winlut_reference(x: Tensor, y: Tensor, theta: Tensor, z: Tensor,
                                     values_t: Tensor, scalars: Tensor, tile: int = 512,
                                     tblk: int = 16):
    """Plain PyTorch version of kernel B5 (same operations, same order)."""
    k = values_t.shape[0]
    tblk = min(tblk, k)
    n = x.shape[0]
    n_pad = -(-n // tile) * tile
    dev = x.device

    def pad(v):  # 1.0, as the reference pads: padded lanes join the minimum
        return F.pad(v, (0, n_pad - n), value=1.0)

    sc = scalars
    rot1 = sc[R1_MU] + sc[R1_SD] * pad(z[0])
    trans = sc[T_MU] + sc[T_SD] * pad(z[1])
    rot2 = sc[R2_MU] + sc[R2_SD] * pad(z[2])
    th1 = pad(theta) + rot1
    xn = pad(x) + trans * torch.cos(th1)
    yn = pad(y) + trans * torch.sin(th1)
    th2 = th1 + rot2
    xf = (sc[WF_C] * xn - sc[WF_S] * yn + sc[WF_X]) * sc[INV_RES] + sc[OFF_X]
    yf = (sc[WF_S] * xn + sc[WF_C] * yn + sc[WF_Y]) * sc[INV_RES] + sc[OFF_Y]
    pi = torch.tensor(math.pi, dtype=torch.float32, device=dev)
    two_pi = torch.tensor(2.0 * math.pi, dtype=torch.float32, device=dev)
    rel = floor_mod(th2 + sc[T_ANG] + pi, two_pi) - pi
    t = rel * sc[INV_DTH] + sc[T_BIAS]
    t_lo = slab_bases(t, k, tblk, tile)
    w = trilinear_reference(values_t, xf[:n], yf[:n], t[:n], t_lo[:n], tblk, sc[MISS],
                            sc[BASE])
    return (xn[:n], yn[:n], torch.cos(th2[:n]), torch.sin(th2[:n]),
            torch.log(torch.clamp_min(w, 1e-30)))


def _check(x, y, theta, z, values_t, scalars, tile, tblk):
    if values_t.dtype != torch.bfloat16 or values_t.dim() != 3:
        raise ValueError(f"values_t must be bfloat16[K, Wx, Wy], got "
                         f"{values_t.dtype}{list(values_t.shape)}")
    n = x.shape[0] if x.dim() == 1 else -1
    shapes = {"x": (n,), "y": (n,), "theta": (n,), "z": (3, n), "scalars": (NUM_SCALARS,)}
    for name, v in (("x", x), ("y", y), ("theta", theta), ("z", z), ("scalars", scalars),
                    ("values_t", values_t)):
        if v.device != values_t.device:
            raise ValueError(f"{name} is on {v.device}, values_t on {values_t.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in shapes and (v.dtype != torch.float32 or v.shape != shapes[name]):
            raise ValueError(f"{name} must be float32{list(shapes[name])}, "
                             f"got {v.dtype}{list(v.shape)}")
    if n > MAX_PARTICLES:
        raise ValueError(f"{n} particles; the kernel takes at most {MAX_PARTICLES}")
    if tile < 1 or tblk < 1 or tile > MAX_TILE:
        raise ValueError(f"tile must be in [1, {MAX_TILE}] and tblk positive, "
                         f"got {tile}, {tblk}")


def fused_propagate_winlut(x: Tensor, y: Tensor, theta: Tensor, z: Tensor, values_t: Tensor,
                           scalars: Tensor, tile: int = 512, tblk: int = 16):
    """One fused pass: ``(x', y', cos', sin', log_lik)``, each ``f32[N]``.

    Args:
      x, y, theta: ``f32[N]`` state planes (heading as an angle).
      z: ``f32[3, N]`` standard normals of rot1 / trans / rot2.
      values_t: ``bf16[K, Wx, Wy]`` x-major windowed LUT.
      scalars: ``f32[18]`` from :func:`pack_scalars`, on the particles'
        device.
      tile: slots per tile (at most ``MAX_TILE``); tblk: θ-slab depth
        (clipped to K).
    """
    global launches
    _check(x, y, theta, z, values_t, scalars, tile, tblk)
    if not on_card(x.device):
        return fused_propagate_winlut_reference(x, y, theta, z, values_t, scalars, tile, tblk)
    k, wx, wy = values_t.shape
    n = x.shape[0]
    outs = torch.empty((5, n), dtype=torch.float32, device=x.device)
    stream = stream_ptr(x.device)
    _fused_step(x.data_ptr(), y.data_ptr(), theta.data_ptr(), z.data_ptr(), n,
                values_t.data_ptr(), k, wx, wy, min(tblk, k), tile, scalars.data_ptr(),
                *(o.data_ptr() for o in outs), stream)
    launches += 1
    return tuple(outs.unbind())
