"""Kernel B11: the code-table lookup of the 3D distance volume.

Port of ``beluga_tpu/ops/pallas_lookup.py:pallas_codebook_lookup``; the
kernel is ``csrc/codebook_lookup.cu``.  :func:`codebook_lookup` launches it
on CUDA tensors and runs :func:`codebook_lookup_reference`, the plain
PyTorch version, on CPU tensors.  It serves
``maps/voxel.py:DistanceGrid3.distance_at`` with a code table, the VDB
filter's distance lookup.

Contract: ``codebook[codes[clip(yi), clip(xi)]]`` for any query shape,
bit-exact, with ``codes`` ``uint8[H, W]`` and ``codebook`` ``f32[K <= 256]``;
a code beyond the codebook reads 0 (the reference's one-hot decode selects
nothing for it).
"""

from __future__ import annotations

import ctypes

import torch

from beluga_tpu_torch.ops._build import Entry, stream_ptr, on_card
from beluga_tpu_torch.ops.gather2d import codebook_lookup as codebook_lookup_reference

Tensor = torch.Tensor

# kernel launches since the count was last set to 0
launches = 0

_p, _i = ctypes.c_void_p, ctypes.c_int
_lookup = Entry("codebook_lookup", "beluga_codebook_lookup",
                [_p, _i, _i, _p, _i, _p, _p, ctypes.c_longlong, _p, _p],
                "codebook_lookup kernel launch")

def _check(codes: Tensor, codebook: Tensor, yi: Tensor, xi: Tensor) -> None:
    for name, t in (("codebook", codebook), ("yi", yi), ("xi", xi)):
        if t.device != codes.device:
            raise ValueError(f"{name} is on {t.device}, codes on {codes.device}")
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError(f"codes must be uint8[H, W], got {codes.dtype}{list(codes.shape)}")
    if codebook.dtype != torch.float32 or codebook.dim() != 1 or codebook.shape[0] > 256:
        raise ValueError(f"codebook must be float32[K <= 256], got "
                         f"{codebook.dtype}{list(codebook.shape)}")
    if yi.shape != xi.shape or yi.dtype != torch.int32 or xi.dtype != torch.int32:
        raise ValueError(f"yi and xi must be int32 of one shape, got {yi.dtype}{list(yi.shape)} "
                         f"and {xi.dtype}{list(xi.shape)}")


def codebook_lookup(codes: Tensor, codebook: Tensor, yi: Tensor, xi: Tensor) -> Tensor:
    """``codebook[codes[clip(yi, 0, H-1), clip(xi, 0, W-1)]]``, float32 in
    the shape of the int32 queries ``yi`` and ``xi``."""
    global launches
    _check(codes, codebook, yi, xi)
    if not on_card(codes.device):
        return codebook_lookup_reference(codes, codebook, yi, xi)
    h, w = codes.shape
    table = codes.contiguous()
    if table.data_ptr() % 16:
        table = table.clone()  # the kernel stages the table in 16-byte words
    y, x = yi.contiguous(), xi.contiguous()
    out = torch.empty(yi.shape, dtype=torch.float32, device=codes.device)
    stream = stream_ptr(codes.device)
    _lookup(table.data_ptr(), h, w, codebook.contiguous().data_ptr(), codebook.shape[0],
            y.data_ptr(), x.data_ptr(), y.numel(), out.data_ptr(), stream)
    launches += 1
    return out
