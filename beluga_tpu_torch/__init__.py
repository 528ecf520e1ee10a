"""PyTorch + CUDA port of beluga_tpu, for one NVIDIA Hopper card.

The layout mirrors ``beluga_tpu/`` module for module; each module names the
function of the JAX package it ports.  The port imports ``torch`` and
numpy only.  Its entry points run on the card unless the caller passes
``device="cpu"``; on a CPU tensor every kernel wrapper runs its plain
PyTorch version instead of the CUDA kernel.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller says
    otherwise.  Raises when CUDA is asked for but absent — the port never
    falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
