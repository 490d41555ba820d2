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

The runtime API of ``paddle_tpu/device/__init__.py`` is here too:
``synchronize``, the memory counters, ``Stream`` / ``Event`` /
``current_stream`` / ``stream_guard``, ``get_all_devices`` and the
``cuda`` namespace. On the card they are torch's (``torch.cuda.Stream``,
``torch.cuda.Event``, ``torch.cuda.stream``, the caching allocator's
statistics), keeping only the methods the JAX package has;
``memory_stats`` keeps JAX's key names (``bytes_in_use``,
``peak_bytes_in_use``, ``bytes_reserved``, ``bytes_limit``). On the CPU
they are the JAX package's no-ops, ``memory_stats`` is ``{}`` and the
counters are 0, as the JAX CPU device gives them. ``TPUPlace`` is the
port's accelerator place, :func:`CUDAPlace`, so that scripts written for
the JAX package run.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device", "Place", "CPUPlace",
           "CUDAPlace", "TPUPlace", "set_device", "get_device", "get_place",
           "device_count", "is_compiled_with_tpu", "get_all_devices",
           "synchronize", "memory_stats", "max_memory_allocated",
           "max_memory_reserved", "memory_allocated", "memory_reserved",
           "cuda", "Stream", "Event", "stream_guard", "current_stream"]

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


TPUPlace = CUDAPlace


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


def get_all_devices():
    """The visible devices: every CUDA device, else the CPU (as
    ``jax.devices()`` gives the CPU device on a host without an
    accelerator)."""
    n = torch.cuda.device_count()
    if n:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cpu")]


def _dev(device=None) -> torch.device:
    """``None`` (the current device), an index (a CUDA device), a name or a
    :class:`Place` -> a ``torch.device``."""
    if isinstance(device, int):
        return resolve_device(f"cuda:{device}")
    if isinstance(device, torch.device):
        return resolve_device(str(device))
    return resolve_device(device)


def synchronize(device=None):
    """Wait until all work queued on the device has finished."""
    d = _dev(device)
    if d.type == "cuda":
        torch.cuda.synchronize(d)


def memory_stats(device=None):
    """The allocator's statistics under the JAX package's key names; ``{}``
    on the CPU."""
    d = _dev(device)
    if d.type != "cuda":
        return {}
    s = torch.cuda.memory_stats(d)
    return {"bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(s.get("reserved_bytes.all.current", 0)),
            "peak_bytes_reserved": int(s.get("reserved_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(d)
                               .total_memory),
            "num_allocs": int(s.get("allocation.all.allocated", 0))}


def memory_allocated(device=None):
    return int(memory_stats(device).get("bytes_in_use", 0))


def max_memory_allocated(device=None):
    s = memory_stats(device)
    return int(s.get("peak_bytes_in_use", s.get("bytes_in_use", 0)))


def memory_reserved(device=None):
    return int(memory_stats(device).get("bytes_reserved", 0))


def max_memory_reserved(device=None):
    s = memory_stats(device)
    return int(s.get("peak_bytes_reserved", s.get("bytes_reserved", 0)))


class Stream:
    """A stream of the device (``torch.cuda.Stream`` on the card; on the
    CPU the JAX package's no-op). ``priority`` 1 is Paddle's high
    priority, 2 its normal one."""

    def __init__(self, device=None, priority=2):
        self._device_arg = device
        d = _dev(device)
        self._stream = torch.cuda.Stream(d, priority=-1 if priority == 1
                                         else 0) if d.type == "cuda" else None

    @classmethod
    def _wrap(cls, stream, device):
        s = cls.__new__(cls)
        s._device_arg, s._stream = device, stream
        return s

    @property
    def device(self):
        return _dev(self._device_arg)

    @property
    def cuda_stream(self):
        """The ``torch.cuda.Stream`` (None on the CPU)."""
        return self._stream

    def synchronize(self):
        if self._stream is not None:
            self._stream.synchronize()

    def wait_stream(self, stream):
        """Work queued on this stream from now on waits for the work
        queued on ``stream`` so far."""
        if self._stream is not None:
            self._stream.wait_stream(stream._stream)

    def wait_event(self, event):
        if self._stream is not None:
            self._stream.wait_event(event._event)

    def record_event(self, event=None):
        event = event or Event()
        event.record(self)
        return event


class Event:
    """An event on a stream (``torch.cuda.Event`` on the card; on the CPU
    the JAX package's no-op, always done)."""

    def __init__(self, enable_timing=False, blocking=False,
                 interprocess=False):
        cuda_ok = torch.cuda.is_available() and \
            _dev(None).type == "cuda"
        self._event = torch.cuda.Event(
            enable_timing=enable_timing, blocking=blocking,
            interprocess=interprocess) if cuda_ok else None

    def record(self, stream=None):
        if self._event is not None:
            stream = stream or current_stream()
            self._event.record(stream._stream)

    def query(self):
        return True if self._event is None else self._event.query()

    def synchronize(self):
        if self._event is not None:
            self._event.synchronize()


def current_stream(device=None):
    """The device's current stream (the one ``stream_guard`` set)."""
    d = _dev(device)
    if d.type != "cuda":
        return Stream._wrap(None, device)
    return Stream._wrap(torch.cuda.current_stream(d), device)


@contextlib.contextmanager
def stream_guard(stream):
    """Queue the work of the block on ``stream`` (``torch.cuda.stream``;
    nothing on the CPU)."""
    if stream is None or stream._stream is None:
        yield
        return
    with torch.cuda.stream(stream._stream):
        yield


class _CudaNamespace:
    """``paddle.device.cuda``: the same calls, on the CUDA devices."""

    Stream = Stream
    Event = Event

    @staticmethod
    def device_count():
        return device_count()

    @staticmethod
    def synchronize(device=None):
        return synchronize(device)

    @staticmethod
    def max_memory_allocated(device=None):
        return max_memory_allocated(device)

    @staticmethod
    def max_memory_reserved(device=None):
        return max_memory_reserved(device)

    @staticmethod
    def memory_allocated(device=None):
        return memory_allocated(device)

    @staticmethod
    def memory_reserved(device=None):
        return memory_reserved(device)

    @staticmethod
    def empty_cache():
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    @staticmethod
    def get_device_properties(device=None):
        d = _dev(device)
        if d.type != "cuda":
            return {"name": "cpu", "platform": "cpu"}
        return {"name": torch.cuda.get_device_name(d), "platform": "gpu"}


cuda = _CudaNamespace()
