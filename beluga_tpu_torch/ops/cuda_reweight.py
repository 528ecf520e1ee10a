"""Kernels B1 and B4: fused likelihood-field reweight.

Port of ``beluga_tpu/ops/pallas_reweight.py:fused_reweight`` on its exact
path (``values3=None``, kernel B1) and on its codebook16 path
(``values3=``, kernel B4, with :func:`build_values3` for the table), each
with and without ``log_space``: the likelihood-field model's ``1 + Σ pz³``
or, for nav2's ``likelihood_field_prob`` model, ``Σ log pz`` (B1-log and
B4-log; B4-log reads a ``bf16(log pz)`` table and ``log(unknown)`` off the
map).  Both kernels are in ``csrc/reweight.cu``, with two entries:
:func:`fused_reweight` takes each particle's field-frame transform
``(tx, ty, cos, sin)`` as the Pallas function does, and
:func:`fused_reweight_states` takes the particle states and the field's
``world_to_field`` and composes them in the kernel, in ``lie.py``'s
operation order, so that the models run no PyTorch operation before the
launch.  On CUDA tensors each launches the kernel; on CPU tensors each runs
its plain PyTorch version (:func:`fused_reweight_reference`,
:func:`fused_reweight_values3_reference`; for the states entry ``lie.py``'s
composition, then those).  Every input may carry leading filter axes (a
fleet of B filters passes ``[B, N]`` particles, ``f32[B, nb, 2]`` points
and ``bool[B, nb]`` masks); the tables are shared, as under JAX's
``vmap``.

Contract: every cell ``floor(x / res)`` matches the plain version bit for
bit; B1 reads the codebook value, B4 the bf16 table entry of the cell;
masked beams are skipped and an off-map endpoint reads ``unknown_prob``
(B4: ``unknown³`` or ``log unknown``); the beam sum runs in another order,
so weights agree to ~1e-5 relative, and B4's weights lie within 5e-3 of
B1's (bf16 keeps 8 significant bits: an entry may be off by 2^-8 relative;
a log entry by 2^-9 of its magnitude); two launches on the same inputs are
bit-equal.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from beluga_tpu_torch.lie import SE2
from beluga_tpu_torch.ops._build import Entry, stream_ptr, on_card
from beluga_tpu_torch.ops.gather2d import codebook_lookup

Tensor = torch.Tensor

MAX_BEAMS = 16384  # shared memory: 8 bytes a beam beside 1 KB of decoded values
MAX_CODES = 256
MAX_FILTERS = 65535

# kernel launches since the counts were last set to 0: B1, B4, B1-log,
# B4-log; and those of them made through the states entry
launches = 0
values3_launches = 0
log_launches = 0
values3_log_launches = 0
states_launches = 0

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_reweight = Entry("reweight", "beluga_reweight",
                  [_p, _i, _i, _i, _p, _i, _p, _p, _p, _p, _i, _i, _p, _p, _i, _f, _f, _p, _i, _i,
                   _p],
                  "reweight kernel launch")


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


def fused_reweight_states_reference(
    codes: Tensor, codebook: Tensor, world_to_field: SE2, states: SE2, points: Tensor,
    beam_mask: Tensor, resolution: float, unknown_prob: float, values3: Tensor | None = None,
    log_space: bool = False,
) -> Tensor:
    """Plain PyTorch version of the states entry: ``world_to_field @
    states`` (``lie.py``), then :func:`fused_reweight_reference` or, with
    ``values3``, :func:`fused_reweight_values3_reference`."""
    tf = world_to_field @ states
    particles = (tf.x, tf.y, tf.rot.cos, tf.rot.sin)
    if values3 is not None:
        return fused_reweight_values3_reference(values3, *particles, points, beam_mask,
                                                resolution, unknown_prob, log_space)
    return fused_reweight_reference(codes, codebook, *particles, points, beam_mask, resolution,
                                    unknown_prob, log_space)


def _meta(t: Tensor | None) -> tuple | None:
    """What the checks read of a tensor: shape, dtype, device, contiguity."""
    return None if t is None else (t.shape, t.dtype, t.device, t.is_contiguous())


@functools.lru_cache(maxsize=64)
def _plan(codes, codebook, particles, states: bool, points, beam_mask, values3) -> tuple:
    """The wrapper's checks on its tensors' :func:`_meta` (raising on what
    the kernel does not take), cached by them: whether the kernel runs, and
    ``(H, W, K, n, nb, filters)``.  ``particles`` holds tx, ty, cos and sin
    ``[..., N]``, or with ``states`` the states' xy and rot ``[..., N, 2]``
    and world_to_field's xy and rot ``[2]``."""
    names = (("xy", "rot", "world_to_field.xy", "world_to_field.rot") if states
             else ("tx", "ty", "cos", "sin"))
    tensors = {"codes": codes, "codebook": codebook, **dict(zip(names, particles)),
               "points": points, "beam_mask": beam_mask}
    if values3 is not None:
        tensors["values3"] = values3
    device = codes[2]
    for name, (_, _, dev, contiguous) in tensors.items():
        if dev != device:
            raise ValueError(f"{name} is on {dev}, codes on {device}")
        if not contiguous:
            raise ValueError(f"{name} must be contiguous")
    kernel = on_card(device)
    (cshape, cdtype, _, _), (bshape, bdtype, _, _) = codes, codebook
    if cdtype != torch.uint8 or len(cshape) != 2:
        raise ValueError(f"codes must be uint8[H, W], got {cdtype}{list(cshape)}")
    if bdtype != torch.float32 or len(bshape) != 1 or not 0 < bshape[0] <= MAX_CODES:
        raise ValueError(f"codebook must be float32[K], 0 < K <= {MAX_CODES}")
    if values3 is not None and (values3[1] != torch.bfloat16 or values3[0] != cshape):
        raise ValueError(f"values3 must be bfloat16{list(cshape)}, "
                         f"got {values3[1]}{list(values3[0])}")
    shape = tuple(particles[0][0])
    if states:
        if len(shape) < 2 or shape[-1] != 2:
            raise ValueError(f"xy must be float32[..., N, 2], got {list(shape)}")
        lead, n = shape[:-2], shape[-2]
    else:
        if len(shape) < 1:
            raise ValueError("tx must be float32[..., N]")
        lead, n = shape[:-1], shape[-1]
    for i, name in enumerate(names):
        pshape, pdtype = particles[i][:2]
        expected = (2,) if states and i >= 2 else shape
        if pdtype != torch.float32 or tuple(pshape) != expected:
            raise ValueError(f"{name} must be float32{list(expected)}, "
                             f"got {pdtype}{list(pshape)}")
    pshape, pdtype = points[:2]
    nb = pshape[-2] if len(pshape) >= 2 else 0
    if pdtype != torch.float32 or tuple(pshape) != (*lead, nb, 2):
        raise ValueError(f"points must be float32[..., nb, 2] with the particles' filter "
                         f"axes {list(lead)}, got {pdtype}{list(pshape)}")
    if beam_mask[1] != torch.bool or tuple(beam_mask[0]) != (*lead, nb):
        raise ValueError(f"beam_mask must be bool{list((*lead, nb))}")
    if nb > MAX_BEAMS:
        raise ValueError(f"{nb} beams; the kernel takes at most {MAX_BEAMS}")
    filters = math.prod(lead)
    if filters > MAX_FILTERS:
        raise ValueError(f"{filters} filters; the kernel takes at most {MAX_FILTERS}")
    return kernel, (cshape[0], cshape[1], bshape[0], n, nb, filters)


def _launch(plan, codes, codebook, particles, states: bool, points, beam_mask, resolution,
            unknown_prob, values3, log_space) -> Tensor:
    global launches, values3_launches, log_launches, values3_log_launches, states_launches
    h, w, k, n, nb, filters = plan
    shape = particles[0].shape[:-1] if states else particles[0].shape
    out = torch.empty(shape, dtype=torch.float32, device=codes.device)
    stream = stream_ptr(codes.device)
    table = codes if values3 is None else values3
    _reweight(table.data_ptr(), int(values3 is not None), h, w, codebook.data_ptr(), k,
              *(t.data_ptr() for t in particles), int(states), n, points.data_ptr(),
              beam_mask.data_ptr(), nb, resolution, unknown_prob, out.data_ptr(), filters,
              int(log_space), stream)
    if values3 is None and log_space:
        log_launches += 1
    elif values3 is None:
        launches += 1
    elif log_space:
        values3_log_launches += 1
    else:
        values3_launches += 1
    states_launches += states
    return out


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

    The checks are cached by the tensors' shapes, dtypes, devices and
    contiguity.
    """
    particles = (tx, ty, cos, sin)
    kernel, plan = _plan(_meta(codes), _meta(codebook), tuple(map(_meta, particles)), False,
                         _meta(points), _meta(beam_mask), _meta(values3))
    if not kernel:
        if values3 is not None:
            return fused_reweight_values3_reference(
                values3, tx, ty, cos, sin, points, beam_mask, resolution, unknown_prob,
                log_space)
        return fused_reweight_reference(
            codes, codebook, tx, ty, cos, sin, points, beam_mask, resolution, unknown_prob,
            log_space)
    return _launch(plan, codes, codebook, particles, False, points, beam_mask, resolution,
                   unknown_prob, values3, log_space)


def fused_reweight_states(
    codes: Tensor, codebook: Tensor, world_to_field: SE2, states: SE2, points: Tensor,
    beam_mask: Tensor, resolution: float, unknown_prob: float, values3: Tensor | None = None,
    log_space: bool = False,
) -> Tensor:
    """:func:`fused_reweight` of ``world_to_field @ states``, the transform
    composed in the kernel in ``lie.py``'s operation order (so its cells
    equal the plain composition's bit for bit), ``f32[..., N]``.

    Args:
      world_to_field: the field's ``SE2`` of one pose, ``xy`` and ``rot.z``
        ``f32[2]`` on the tables' device.
      states: ``SE2`` particles, ``xy`` and ``rot.z`` ``f32[..., N, 2]``,
        contiguous.
      the rest: as :func:`fused_reweight`.
    """
    particles = (states.xy, states.rot.z, world_to_field.xy, world_to_field.rot.z)
    kernel, plan = _plan(_meta(codes), _meta(codebook), tuple(map(_meta, particles)), True,
                         _meta(points), _meta(beam_mask), _meta(values3))
    if not kernel:
        return fused_reweight_states_reference(codes, codebook, world_to_field, states, points,
                                               beam_mask, resolution, unknown_prob, values3,
                                               log_space)
    return _launch(plan, codes, codebook, particles, True, points, beam_mask, resolution,
                   unknown_prob, values3, log_space)
