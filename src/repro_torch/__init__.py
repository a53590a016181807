"""PyTorch + CUDA port of the ``repro`` Bloom-filter library for NVIDIA Hopper.

The package mirrors ``repro``'s module layout so each counterpart is easy to
find (``core/hashing.py``, ``core/variants.py``, ``kernels/ops.py``,
``api/...``). It imports ``torch`` and ``numpy`` only.

Every entry point takes ``device=None``, which means :func:`default_device`
(the CUDA card). Without a card a CUDA call raises ``RuntimeError``; it never
carries on on the CPU. Pass ``device="cpu"`` to run the plain PyTorch
versions of the kernels, as the tests do.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def default_device() -> torch.device:
    """The device an entry point uses when the caller names none."""
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device`` (``None`` = :func:`default_device`).

    Raises ``RuntimeError`` for a CUDA device when no card is present."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
