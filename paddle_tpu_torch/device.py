"""Device selection for the PyTorch/CUDA port (``paddle_tpu/core/
device.py``).

Every entry point of the port runs on the card (``cuda``) unless the
caller passes ``device="cpu"``. Where CUDA is absent and the CPU was not
asked for, :func:`resolve_device` raises: the port never carries on on the
CPU by itself, so a run that meant to measure the card cannot quietly
measure the host instead.

``set_device`` takes Paddle's names (``"gpu"``, ``"gpu:0"``, ``"cpu"``;
``"cuda"`` too) and sets :data:`DEFAULT_DEVICE`, the device every entry
point and creation op uses when it is given none.
"""
from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device", "Place", "CPUPlace",
           "CUDAPlace", "set_device", "get_device", "get_place",
           "device_count", "is_compiled_with_tpu"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current device (``cuda`` unless ``set_device``
    chose another); a CUDA request without CUDA raises; ``cpu`` (the
    tests' choice) is taken as given. Takes a :class:`Place` and Paddle's
    ``"gpu"`` names too."""
    if device is None:
        device = DEFAULT_DEVICE
    if isinstance(device, Place):
        device = device.torch_device()
    elif isinstance(device, str):
        device = _torch_name(device)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on the GPU by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


def _torch_name(name: str) -> str:
    """Paddle's ``"gpu"`` / ``"gpu:1"`` -> torch's ``"cuda"`` /
    ``"cuda:1"``; other names pass."""
    kind, _, idx = name.partition(":")
    if kind == "gpu":
        kind = "cuda"
    return f"{kind}:{idx}" if idx else kind


class Place:
    """A device as Paddle names it (``paddle_tpu/core/device.py:14``):
    ``Place("gpu", 0)``, ``Place("cpu")``."""

    def __init__(self, device_type: str, device_id: int = 0):
        self.device_type = "gpu" if device_type == "cuda" else device_type
        self.device_id = device_id

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def is_gpu_place(self):
        return self.device_type == "gpu"

    def is_cpu_place(self):
        return self.device_type == "cpu"

    def torch_device(self) -> torch.device:
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)


def CPUPlace(idx=0):
    return Place("cpu", idx)


def CUDAPlace(idx=0):
    return Place("gpu", idx)


def set_device(device) -> Place:
    """``set_device("gpu")`` / ``"gpu:0"`` / ``"cpu"``: the device that
    entry points and creation ops use from now on. A GPU without CUDA
    raises."""
    global DEFAULT_DEVICE
    dev = resolve_device(device)
    if dev.type == "cuda":
        idx = dev.index or 0
        if idx >= torch.cuda.device_count():
            raise ValueError(f"no GPU {idx}: {torch.cuda.device_count()} "
                             f"visible")
        DEFAULT_DEVICE = f"cuda:{idx}"
        return Place("gpu", idx)
    DEFAULT_DEVICE = "cpu"
    return Place("cpu", 0)


def get_place() -> Place:
    dev = torch.device(_torch_name(DEFAULT_DEVICE))
    if dev.type == "cpu":
        return Place("cpu", 0)
    return Place("gpu", dev.index or 0)


def get_device() -> str:
    """``"gpu:0"`` or ``"cpu"``, as Paddle names the current device."""
    p = get_place()
    return "cpu" if p.is_cpu_place() else f"gpu:{p.device_id}"


def device_count() -> int:
    return torch.cuda.device_count()


def is_compiled_with_tpu() -> bool:
    return False
