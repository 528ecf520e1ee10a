"""Code-table construction and lookup (port of the codebook part of
``beluga_tpu/ops/gather2d.py``).

A likelihood field is stored as ``uint8`` codes into a float32 codebook of
at most 256 entries (maps/codebook.py).  The JAX package keeps codes as
int32 and decodes them with one-hot matrix products because of how the TPU
works; here a lookup is an ordinary indexed load.  The lowrank and one-hot
modes wait for ROADMAP item A11.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

# table rows per encode block: bounds the [rows, W, K] distance tensor
_ROWS = 64


def build_device_codebook(table: Tensor, fallback_book: Tensor) -> Tensor:
    """The table's distinct values in ascending order, padded with the
    largest one to the fallback's length; the fallback (the analytic host
    proposal) when there are more distinct values than slots."""
    cap = fallback_book.shape[0]
    uniq = torch.unique(table.reshape(-1), sorted=True)
    if uniq.numel() > cap:
        return fallback_book.to(table.device)
    book = torch.full((cap,), 0.0, dtype=table.dtype, device=table.device)
    book[: uniq.numel()] = uniq
    book[uniq.numel():] = uniq[-1]
    return book


def encode_table(table: Tensor, codebook: Tensor) -> Tensor:
    """Nearest-codebook code of every entry, ``uint8[H, W]`` (first index on
    ties, as ``argmin``)."""
    if codebook.shape[0] > 256:
        raise ValueError(f"codebook has {codebook.shape[0]} entries; at most 256 fit uint8 codes")
    return torch.cat([
        torch.argmin(torch.abs(table[r : r + _ROWS, :, None] - codebook), dim=-1)
        for r in range(0, table.shape[0], _ROWS)
    ]).to(torch.uint8)


def codebook_lookup(codes: Tensor, codebook: Tensor, yi: Tensor, xi: Tensor) -> Tensor:
    """``codebook[codes[clip(yi), clip(xi)]]`` for any query shape; a code
    beyond the codebook reads 0 (the semantics of the reference's one-hot
    decode, gather2d.py:122-163)."""
    h, w = codes.shape
    y = torch.clamp(yi, 0, h - 1).long()
    x = torch.clamp(xi, 0, w - 1).long()
    code = codes[y, x].long()
    k = codebook.shape[0]
    return torch.where(code < k, codebook[torch.clamp(code, max=k - 1)], 0.0)
