"""Table construction and lookup (port of ``beluga_tpu/ops/gather2d.py``).

A likelihood field is stored as ``uint8`` codes into a float32 codebook of
at most 256 entries (maps/codebook.py), or read as the float table itself.
The JAX package keeps codes as int32 and decodes them with one-hot matrix
products because of how the TPU works; here a lookup is an ordinary
indexed load.

Modes of :func:`table_lookup`:

* ``gather``: the clipped indexed load ``table[clip(yi), clip(xi)]``;
* ``onehot``: the reference's one-hot matrix product exists only for the
  TPU's matrix unit and selects the same exact entries, so in the port it
  is the same clipped indexed load;
* ``auto``: the same load (the reference's CPU choice).

The ``lowrank`` mode reads an SVD-factored table, :func:`factorize_table`
then :func:`lowrank_lookup`, with bf16-rounded factors as the reference's
matrix unit reads them.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor

# table rows per encode block: bounds the [rows, W, K] distance tensor
_ROWS = 64
_MODES = ("gather", "onehot", "auto")


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
    code = table_lookup(codes, yi, xi).long()
    k = codebook.shape[0]
    return torch.where(code < k, codebook[torch.clamp(code, max=k - 1)], 0.0)


def table_lookup(table: Tensor, yi: Tensor, xi: Tensor, mode: str = "auto") -> Tensor:
    """Clipped 2D lookup ``table[clip(yi, 0, H-1), clip(xi, 0, W-1)]`` for
    any query shape (gather2d.py:211-231); every mode is this load."""
    if mode not in _MODES:
        raise ValueError(f"unknown lookup mode {mode!r}")
    h, w = table.shape
    return table[torch.clamp(yi, 0, h - 1).long(), torch.clamp(xi, 0, w - 1).long()]


def factorize_table(table: Tensor, rank: int) -> tuple[Tensor, Tensor]:
    """``(U·s [H, r], V [W, r])`` float32, on the table's device: the
    rank-``rank`` SVD of the table, in float64 numpy on the host as the
    reference does it (gather2d.py:166-179); map-load work."""
    t = table.detach().cpu().numpy().astype(np.float64)
    u, s, vt = np.linalg.svd(t, full_matrices=False)
    return (torch.as_tensor((u[:, :rank] * s[None, :rank]).astype(np.float32)).to(table.device),
            torch.as_tensor(vt[:rank].T.astype(np.float32)).to(table.device))


def lowrank_lookup(u: Tensor, v: Tensor, yi: Tensor, xi: Tensor) -> Tensor:
    """``Σ_r f32(bf16 U[y, r]) · f32(bf16 V[x, r])`` at the clipped cells
    (gather2d.py:182-208): the reference feeds bf16 factors to its matrix
    unit; the products are exact in float32 and the sum runs over ``r``."""
    h, w = u.shape[0], v.shape[0]
    ub = u.to(torch.bfloat16).float()
    vb = v.to(torch.bfloat16).float()
    uy = ub[torch.clamp(yi, 0, h - 1).long()]
    vx = vb[torch.clamp(xi, 0, w - 1).long()]
    return torch.sum(uy * vx, dim=-1)
