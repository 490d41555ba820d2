"""Device selection for the PyTorch/CUDA port.

Every entry point of the port runs on the card (``cuda``) unless the
caller passes ``device="cpu"``. Where CUDA is absent and the CPU was not
asked for, :func:`resolve_device` raises: the port never carries on on the
CPU by itself, so a run that meant to measure the card cannot quietly
measure the host instead.
"""
from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA request without CUDA raises; ``cpu``
    (the tests' choice) is taken as given."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on the GPU by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev
