"""Kernel B1: fused likelihood-field reweight through the code table.

Port of ``beluga_tpu/ops/pallas_reweight.py:fused_reweight`` on its exact
path (``values3=None``, ``log_space=False``); the kernel is
``csrc/reweight.cu``.  :func:`fused_reweight` launches it on CUDA tensors
and runs :func:`fused_reweight_reference`, the plain PyTorch version, on
CPU tensors.

Contract: every table lookup is exact (the cell ``floor(x / res)`` and the
codebook value match the plain version bit for bit); the beam sum runs in
another order, so weights agree to ~1e-5 relative.
"""

from __future__ import annotations

import ctypes

import torch

from beluga_tpu_torch.ops.gather2d import codebook_lookup

Tensor = torch.Tensor

MAX_BEAMS = 16384  # shared memory: (256 + 3 * beams) floats per block
MAX_CODES = 256

# kernel launches since the count was last set to 0
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from beluga_tpu_torch.ops._build import load_library

        fn = load_library("reweight").beluga_reweight
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def endpoint_cells(tx: Tensor, ty: Tensor, cos: Tensor, sin: Tensor, points: Tensor,
                   resolution: float) -> tuple[Tensor, Tensor]:
    """Cell coordinates ``floor(x / res)``, ``floor(y / res)`` of every
    (particle, beam) endpoint as float32 ``[N, B]``, in the reference's
    operation order (likelihood_field.py:226-233).  The division is by a
    tensor on the same device, never by a Python number: CUDA would turn
    that into a multiplication by the reciprocal and move cell edges."""
    c, s = cos[:, None], sin[:, None]
    px, py = points[None, :, 0], points[None, :, 1]
    x = px * c - py * s + tx[:, None]
    y = px * s + py * c + ty[:, None]
    res = torch.full((), resolution, dtype=torch.float32, device=x.device)
    return torch.floor(x / res), torch.floor(y / res)


def fused_reweight_reference(
    codes: Tensor, codebook: Tensor, tx: Tensor, ty: Tensor, cos: Tensor,
    sin: Tensor, points: Tensor, beam_mask: Tensor, resolution: float,
    unknown_prob: float,
) -> Tensor:
    """Plain PyTorch version of the kernel."""
    fx, fy = endpoint_cells(tx, ty, cos, sin, points, resolution)
    h, w = codes.shape
    inside = (fx >= 0) & (fx < w) & (fy >= 0) & (fy < h)
    zero = torch.zeros((), dtype=torch.float32, device=fx.device)
    vals = codebook_lookup(
        codes, codebook,
        torch.where(inside, fy, zero).long(), torch.where(inside, fx, zero).long(),
    )
    pz = torch.where(inside, vals, unknown_prob)
    return 1.0 + torch.sum(torch.where(beam_mask[None, :], pz * pz * pz, 0.0), dim=-1)


def _check(codes, codebook, tx, ty, cos, sin, points, beam_mask):
    device = codes.device
    tensors = {"codes": codes, "codebook": codebook, "tx": tx, "ty": ty, "cos": cos,
               "sin": sin, "points": points, "beam_mask": beam_mask}
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, codes on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError(f"codes must be uint8[H, W], got {codes.dtype}{list(codes.shape)}")
    if codebook.dtype != torch.float32 or codebook.dim() != 1 or not (
        0 < codebook.shape[0] <= MAX_CODES
    ):
        raise ValueError(f"codebook must be float32[K], 0 < K <= {MAX_CODES}")
    n = tx.shape[0]
    for name in ("tx", "ty", "cos", "sin"):
        t = tensors[name]
        if t.dtype != torch.float32 or t.shape != (n,):
            raise ValueError(f"{name} must be float32[{n}], got {t.dtype}{list(t.shape)}")
    nb = points.shape[0]
    if points.dtype != torch.float32 or points.shape != (nb, 2):
        raise ValueError(f"points must be float32[B, 2], got {points.dtype}{list(points.shape)}")
    if beam_mask.dtype != torch.bool or beam_mask.shape != (nb,):
        raise ValueError(f"beam_mask must be bool[{nb}]")
    if nb > MAX_BEAMS:
        raise ValueError(f"{nb} beams; the kernel takes at most {MAX_BEAMS}")


def fused_reweight(
    codes: Tensor, codebook: Tensor, tx: Tensor, ty: Tensor, cos: Tensor,
    sin: Tensor, points: Tensor, beam_mask: Tensor, resolution: float,
    unknown_prob: float,
) -> Tensor:
    """AMCL-parity weights ``1 + Σ_b pz_b³``, ``f32[N]``.

    Args:
      codes: ``uint8[H, W]`` field code table; codebook: ``f32[K]``, K <= 256.
      tx/ty/cos/sin: ``f32[N]`` per-particle field-frame transform.
      points: ``f32[B, 2]`` beam endpoints in the base frame;
        beam_mask: ``bool[B]``.
      resolution, unknown_prob: float32 values as Python floats.
    """
    global launches
    _check(codes, codebook, tx, ty, cos, sin, points, beam_mask)
    if codes.device.type == "cpu":
        return fused_reweight_reference(
            codes, codebook, tx, ty, cos, sin, points, beam_mask, resolution, unknown_prob
        )
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    h, w = codes.shape
    n, nb = tx.shape[0], points.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=codes.device)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    err = _kernel()(
        codes.data_ptr(), h, w, codebook.data_ptr(), codebook.shape[0],
        tx.data_ptr(), ty.data_ptr(), cos.data_ptr(), sin.data_ptr(), n,
        points.data_ptr(), beam_mask.data_ptr(), nb, resolution, unknown_prob,
        out.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"reweight kernel launch failed: cudaError {err}")
    launches += 1
    return out
