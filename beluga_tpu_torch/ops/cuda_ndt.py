"""Kernel B10: the NDT cell probe.

Port of ``beluga_tpu/ops/pallas_ndt.py:ndt_probe``; the kernel is
``csrc/ndt_probe.cu``.  :func:`ndt_probe` launches it on CUDA tensors and
runs :func:`ndt_probe_reference`, the plain PyTorch version, on CPU
tensors.  It serves ``maps/ndt.py:NdtMap.lookup_gaussians``, the stencil
probe of the NDT sensor model for maps of more than 256 rows.

Contract: ``queries`` are encoded cell keys; each is matched exactly
against the map's sorted live keys ``keys[:num_cells]``; a match fetches
that row of ``values`` ``f32[M, P]`` (the cell's mean, then its flattened
covariance) as bit-exact float32 copies, and no match gives zeros and
``found = False``.  Keys are 32-bit unsigned values: this module and the
plain version hold them in int64 tensors in ``[0, 2^32)`` (PyTorch's
``uint32`` has few operators), and the kernel takes them as ``uint32_t``
(their low 32 bits, through an int32 tensor of the same bits).
"""

from __future__ import annotations

import ctypes

import torch

Tensor = torch.Tensor

# kernel launches since the count was last set to 0
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from beluga_tpu_torch.ops._build import load_library

        fn = load_library("ndt_probe").beluga_ndt_probe
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def ndt_probe_reference(keys: Tensor, values: Tensor, num_cells: int,
                        queries: Tensor) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version of the kernel: ``torch.searchsorted`` of the
    int64 queries in the live keys, then a row gather."""
    live = keys[:num_cells]
    p = values.shape[-1]
    if num_cells == 0:
        return (torch.zeros((*queries.shape, p), dtype=torch.float32, device=values.device),
                torch.zeros(queries.shape, dtype=torch.bool, device=values.device))
    idx = torch.clamp_max(torch.searchsorted(live, queries), num_cells - 1)
    found = live[idx] == queries
    rows = values[idx]
    return torch.where(found[..., None], rows, 0.0), found


def _check(keys: Tensor, values: Tensor, num_cells: int, queries: Tensor) -> None:
    for name, t in (("values", values), ("queries", queries)):
        if t.device != keys.device:
            raise ValueError(f"{name} is on {t.device}, keys on {keys.device}")
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise ValueError(f"keys must be int64[M], got {keys.dtype}{list(keys.shape)}")
    if queries.dtype != torch.int64:
        raise ValueError(f"queries must be int64 keys, got {queries.dtype}")
    if values.dtype != torch.float32 or values.dim() != 2 or values.shape[0] != keys.shape[0]:
        raise ValueError(f"values must be float32[{keys.shape[0]}, P], got "
                         f"{values.dtype}{list(values.shape)}")
    if not 0 <= num_cells <= keys.shape[0]:
        raise ValueError(f"num_cells {num_cells} outside [0, {keys.shape[0]}]")


def ndt_probe(keys: Tensor, values: Tensor, num_cells: int,
              queries: Tensor) -> tuple[Tensor, Tensor]:
    """``(f32[..., P] values, bool[...] found)`` for the int64 ``queries``
    ``[...]`` against the sorted int64 ``keys`` ``[M]`` of which the first
    ``num_cells`` are live, with ``values`` ``f32[M, P]``."""
    global launches
    _check(keys, values, num_cells, queries)
    if keys.device.type == "cpu":
        return ndt_probe_reference(keys, values, num_cells, queries)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    p = values.shape[1]
    # the keys' low 32 bits as int32 (the conversion wraps), read by the
    # kernel as uint32_t
    q32 = queries.to(torch.int32).contiguous()
    k32 = keys.to(torch.int32).contiguous()
    vals = values.contiguous()
    out = torch.empty((*queries.shape, p), dtype=torch.float32, device=keys.device)
    found = torch.empty(queries.shape, dtype=torch.uint8, device=keys.device)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    err = _kernel()(k32.data_ptr(), num_cells, vals.data_ptr(), p, q32.data_ptr(),
                    q32.numel(), out.data_ptr(), found.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ndt_probe kernel launch failed: cudaError {err}")
    launches += 1
    return out, found.view(torch.bool)
