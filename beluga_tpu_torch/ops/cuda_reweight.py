"""Kernels B1 and B4: fused likelihood-field reweight.

Port of ``beluga_tpu/ops/pallas_reweight.py:fused_reweight`` on its exact
path (``values3=None``, kernel B1) and on its codebook16 path
(``values3=``, kernel B4, with :func:`build_values3` for the table), each
with and without ``log_space``: the likelihood-field model's ``1 + Σ pz³``
or, for nav2's ``likelihood_field_prob`` model, ``Σ log pz`` (B1-log and
B4-log; B4-log reads a ``bf16(log pz)`` table and ``log(unknown)`` off the
map).  Both kernels are in ``csrc/reweight.cu``.  :func:`fused_reweight`
launches them on CUDA tensors and runs :func:`fused_reweight_reference` or
:func:`fused_reweight_values3_reference`, the plain PyTorch versions, on
CPU tensors.  Every input may carry leading filter axes (a fleet of B
filters passes ``f32[B, N]`` particles, ``f32[B, nb, 2]`` points and
``bool[B, nb]`` masks); the tables are shared, as under JAX's ``vmap``.

Contract: every cell ``floor(x / res)`` matches the plain version bit for
bit; B1 reads the codebook value, B4 the bf16 table entry of the cell; the
beam sum runs in another order, so weights agree to ~1e-5 relative, and
B4's weights lie within 5e-3 of B1's (bf16 keeps 8 significant bits: an
entry may be off by 2^-8 relative; a log entry by 2^-9 of its magnitude).
"""

from __future__ import annotations

import ctypes
import math

import torch

from beluga_tpu_torch.ops.gather2d import codebook_lookup

Tensor = torch.Tensor

MAX_BEAMS = 16384  # shared memory: (256 + 3 * beams) floats per block
MAX_CODES = 256
MAX_FILTERS = 65535  # grid.y

# kernel launches since the count was last set to 0: B1, B4, B1-log, B4-log
launches = 0
values3_launches = 0
log_launches = 0
values3_log_launches = 0

_fns: dict = {}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        from beluga_tpu_torch.ops._build import load_library

        fn = getattr(load_library("reweight"), name)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        table = [p, i, i, p, i] if name == "beluga_reweight" else [p, i, i]
        fn.argtypes = table + [p, p, p, p, i, p, p, i, f, f, p, i, i, p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def build_values3(codes: Tensor, codebook: Tensor, log_space: bool = False) -> Tensor:
    """Kernel B4's table ``bf16[H, W] = bf16(book³[codes])``, or with
    ``log_space`` ``bf16(log book[codes])`` (pallas_reweight.py:364-386).
    The cube is ``b * b * b`` in float32, as XLA lowers ``** 3``; both
    frameworks round to bf16 to nearest even.  The reference's transposed,
    padded and shifted copies serve Mosaic's windows only."""
    book = codebook.float()
    vals = torch.log(book) if log_space else book * book * book
    return vals[codes.long()].to(torch.bfloat16)


def endpoint_cells(tx: Tensor, ty: Tensor, cos: Tensor, sin: Tensor, points: Tensor,
                   resolution: float) -> tuple[Tensor, Tensor]:
    """Cell coordinates ``floor(x / res)``, ``floor(y / res)`` of every
    (particle, beam) endpoint as float32 ``[..., N, nb]``, in the
    reference's operation order (likelihood_field.py:226-233).  The
    division is by a tensor on the same device, never by a Python number:
    CUDA would turn that into a multiplication by the reciprocal and move
    cell edges."""
    c, s = cos[..., :, None], sin[..., :, None]
    px, py = points[..., None, :, 0], points[..., None, :, 1]
    x = px * c - py * s + tx[..., :, None]
    y = px * s + py * c + ty[..., :, None]
    res = torch.full((), resolution, dtype=torch.float32, device=x.device)
    return torch.floor(x / res), torch.floor(y / res)


def map_cells(shape, tx, ty, cos, sin, points, resolution):
    """``(inside, row, col)`` of every endpoint on an ``(H, W)`` map, the
    cell clipped to 0 off the map."""
    fx, fy = endpoint_cells(tx, ty, cos, sin, points, resolution)
    h, w = shape
    inside = (fx >= 0) & (fx < w) & (fy >= 0) & (fy < h)
    zero = torch.zeros((), dtype=torch.float32, device=fx.device)
    return inside, torch.where(inside, fy, zero).long(), torch.where(inside, fx, zero).long()


def fused_reweight_reference(
    codes: Tensor, codebook: Tensor, tx: Tensor, ty: Tensor, cos: Tensor,
    sin: Tensor, points: Tensor, beam_mask: Tensor, resolution: float,
    unknown_prob: float, log_space: bool = False,
) -> Tensor:
    """Plain PyTorch version of kernel B1: ``1 + Σ pz³``, or with
    ``log_space`` ``Σ log pz`` (pallas_reweight.py:248, 306, 312)."""
    inside, row, col = map_cells(codes.shape, tx, ty, cos, sin, points, resolution)
    pz = torch.where(inside, codebook_lookup(codes, codebook, row, col), unknown_prob)
    if log_space:
        return torch.sum(torch.where(beam_mask[..., None, :], torch.log(pz), 0.0), dim=-1)
    return 1.0 + torch.sum(torch.where(beam_mask[..., None, :], pz * pz * pz, 0.0), dim=-1)


def fused_reweight_values3_reference(
    values3: Tensor, tx: Tensor, ty: Tensor, cos: Tensor, sin: Tensor,
    points: Tensor, beam_mask: Tensor, resolution: float, unknown_prob: float,
    log_space: bool = False,
) -> Tensor:
    """Plain PyTorch version of kernel B4: ``1 + Σ pz³`` with in-map pz³
    read from the bf16 table and ``unknown·unknown·unknown`` off the map
    (pallas_reweight.py:183-184, 203), or with ``log_space`` ``Σ log pz``
    with in-map ``log pz`` from the table and ``log(unknown)`` off it."""
    inside, row, col = map_cells(values3.shape, tx, ty, cos, sin, points, resolution)
    u = torch.tensor(unknown_prob, dtype=torch.float32, device=tx.device)
    off_map = torch.log(u) if log_space else u * u * u
    pz3 = torch.where(inside, values3[row, col].float(), off_map)
    total = torch.sum(torch.where(beam_mask[..., None, :], pz3, 0.0), dim=-1)
    return total if log_space else 1.0 + total


def _check(codes, codebook, tx, ty, cos, sin, points, beam_mask, values3):
    device = codes.device
    tensors = {"codes": codes, "codebook": codebook, "tx": tx, "ty": ty, "cos": cos,
               "sin": sin, "points": points, "beam_mask": beam_mask}
    if values3 is not None:
        tensors["values3"] = values3
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
    if values3 is not None and (values3.dtype != torch.bfloat16 or values3.shape != codes.shape):
        raise ValueError(f"values3 must be bfloat16{list(codes.shape)}, "
                         f"got {values3.dtype}{list(values3.shape)}")
    shape = tx.shape
    if tx.dim() < 1:
        raise ValueError("tx must be float32[..., N]")
    for name in ("tx", "ty", "cos", "sin"):
        t = tensors[name]
        if t.dtype != torch.float32 or t.shape != shape:
            raise ValueError(f"{name} must be float32{list(shape)}, got {t.dtype}{list(t.shape)}")
    lead = tuple(shape[:-1])
    nb = points.shape[-2] if points.dim() >= 2 else 0
    if points.dtype != torch.float32 or points.shape != (*lead, nb, 2):
        raise ValueError(f"points must be float32[..., nb, 2] with the particles' filter "
                         f"axes {list(lead)}, got {points.dtype}{list(points.shape)}")
    if beam_mask.dtype != torch.bool or beam_mask.shape != (*lead, nb):
        raise ValueError(f"beam_mask must be bool{list((*lead, nb))}")
    if nb > MAX_BEAMS:
        raise ValueError(f"{nb} beams; the kernel takes at most {MAX_BEAMS}")
    if math.prod(lead) > MAX_FILTERS:
        raise ValueError(f"{math.prod(lead)} filters; the kernel takes at most {MAX_FILTERS}")


def fused_reweight(
    codes: Tensor, codebook: Tensor, tx: Tensor, ty: Tensor, cos: Tensor,
    sin: Tensor, points: Tensor, beam_mask: Tensor, resolution: float,
    unknown_prob: float, values3: Tensor | None = None, log_space: bool = False,
) -> Tensor:
    """AMCL-parity weights ``1 + Σ_b pz_b³``, or with ``log_space`` the
    probability model's log-weights ``Σ_b log pz_b``, ``f32[..., N]``.

    Args:
      codes: ``uint8[H, W]`` field code table; codebook: ``f32[K]``, K <= 256.
      tx/ty/cos/sin: ``f32[..., N]`` per-particle field-frame transform.
      points: ``f32[..., nb, 2]`` beam endpoints in the base frame;
        beam_mask: ``bool[..., nb]``, with the particles' filter axes.
      resolution, unknown_prob: float32 values as Python floats.
      values3: ``bf16[H, W]`` from :func:`build_values3` (built with the
        same ``log_space``): kernel B4 (the codebook16 mode) instead of B1.
      log_space: the probability model's sum of logs, base 0.
    """
    global launches, values3_launches, log_launches, values3_log_launches
    _check(codes, codebook, tx, ty, cos, sin, points, beam_mask, values3)
    if codes.device.type == "cpu":
        if values3 is not None:
            return fused_reweight_values3_reference(
                values3, tx, ty, cos, sin, points, beam_mask, resolution, unknown_prob,
                log_space)
        return fused_reweight_reference(
            codes, codebook, tx, ty, cos, sin, points, beam_mask, resolution, unknown_prob,
            log_space)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    h, w = codes.shape
    n, nb = tx.shape[-1], points.shape[-2]
    batch = math.prod(tx.shape[:-1])
    out = torch.empty(tx.shape, dtype=torch.float32, device=codes.device)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    particles = (tx.data_ptr(), ty.data_ptr(), cos.data_ptr(), sin.data_ptr(), n,
                 points.data_ptr(), beam_mask.data_ptr(), nb, resolution, unknown_prob,
                 out.data_ptr(), batch, int(log_space), stream)
    if values3 is None:
        err = _kernel("beluga_reweight")(
            codes.data_ptr(), h, w, codebook.data_ptr(), codebook.shape[0], *particles)
    else:
        err = _kernel("beluga_reweight_values3")(values3.data_ptr(), h, w, *particles)
    if err != 0:
        raise RuntimeError(f"reweight kernel launch failed: cudaError {err}")
    if values3 is None and log_space:
        log_launches += 1
    elif values3 is None:
        launches += 1
    elif log_space:
        values3_log_launches += 1
    else:
        values3_launches += 1
    return out
