"""paddle.inference — the deployment predictor, after
``paddle_tpu/inference.py`` (reference: paddle/fluid/inference/api/
analysis_predictor.cc:392, paddle_inference_api.h: Config /
create_predictor / get_input_handle / run).

A :class:`Predictor` is a handle-based wrapper over ``jit.load``: the
``.pdmodel`` that ``jit.save`` wrote is a ``torch.export`` program whose
attention and norms are the hand kernels' ops, and on the card each input
shape of it runs as one CUDA graph (``jit/save_load.py``).
:class:`BatchingPredictor` groups single-example requests into a batch
padded to a bucket, so each bucket is one captured graph.

Where the port differs: :class:`Config`'s device is the card (``"gpu"``
where JAX says ``"tpu"``), ``enable_use_gpu(device_id=i)`` means
``cuda:i`` and ``disable_gpu()`` the CPU; with no card the default
raises instead of falling back. ``copy_to_cpu`` of a bfloat16 output
returns float32 numpy (the card has no ``ml_dtypes``).
"""
from __future__ import annotations

import os
import queue
import threading
import time

import numpy as np
import torch

from .framework.io import _numpy
from .jit.save_load import load as _jit_load

__all__ = ["Config", "Predictor", "create_predictor", "PredictorTensor",
           "BatchingPredictor", "pick_bucket"]


def pick_bucket(n, buckets, strict=False):
    """Smallest bucket >= ``n``: the pad-to-bucket rule of
    :class:`BatchingPredictor` (batch dim) and the bucketed serving
    fallback (batch and sequence dims). When ``n`` exceeds the largest
    bucket the default clamps down to it (callers that split oversize
    batches themselves); ``strict=True`` raises instead, for callers whose
    launch sized by a clamped-down bucket would index past its padding and
    silently truncate the round."""
    for b in buckets:
        if b >= n:
            return b
    if strict:
        raise ValueError(
            f"batch of {n} exceeds the largest configured bucket "
            f"{buckets[-1]} — split the round or widen the bucket set "
            "(a clamped-down launch would truncate the round)")
    return buckets[-1]


class Config:
    """Reference: AnalysisConfig (paddle_analysis_config.h). The program's
    path and its device; the IR and TensorRT knobs are accepted and
    recorded (the export already holds the kernels)."""

    def __init__(self, prog_file=None, params_file=None):
        if prog_file and prog_file.endswith(".pdmodel"):
            prog_file = prog_file[:-len(".pdmodel")]
        self._path = prog_file
        self._enable_memory_optim = True
        self._device = "gpu"
        self._device_id = None
        self._ir_optim = True

    def set_prog_file(self, path):
        self._path = path

    def prog_file(self):
        return (self._path or "") + ".pdmodel"

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._device, self._device_id = "gpu", device_id

    def enable_xpu(self, *a, **k):
        self._device = "gpu"

    def disable_gpu(self):
        self._device = "cpu"

    def switch_ir_optim(self, flag=True):
        self._ir_optim = flag

    def enable_memory_optim(self, flag=True):
        self._enable_memory_optim = flag

    def enable_tensorrt_engine(self, *a, **k):
        pass   # the exported program already runs the hand kernels

    def device(self):
        """The ``torch.device`` the predictor runs on."""
        if self._device == "cpu":
            return torch.device("cpu")
        from .device import resolve_device
        return resolve_device("cuda" if self._device_id is None
                              else f"cuda:{self._device_id}")

    def summary(self):
        return (f"Config(path={self._path!r}, device={self._device}, "
                "engine=torch.export + CUDA graphs)")


class PredictorTensor:
    """Handle-based IO tensor (reference: ZeroCopyTensor)."""

    def __init__(self, name):
        self.name = name
        self._value = None

    def copy_from_cpu(self, arr):
        self._value = np.ascontiguousarray(arr)

    def reshape(self, shape):
        pass   # shapes come from the data in copy_from_cpu

    def copy_to_cpu(self):
        return _numpy(self._value)

    def shape(self):
        return list(self._value.shape) if self._value is not None else []


class Predictor:
    """Reference: AnalysisPredictor (analysis_predictor.cc:392 init, :1205
    Run): the loaded program and its named IO handles."""

    def __init__(self, config):
        if isinstance(config, str):
            config = Config(config)
        self._config = config
        path = config._path
        if path is None or not os.path.exists(path + ".pdmodel"):
            raise FileNotFoundError(
                f"no exported model at {path!r}; produce one with "
                "paddle.jit.save(layer, path, input_spec=[...])")
        self._layer = _jit_load(path, device=config.device())
        n_in = len(self._layer._meta.get("input_specs", []))
        self._inputs = [PredictorTensor(f"input_{i}") for i in range(n_in)]
        self._outputs: list = []

    def get_input_names(self):
        return [t.name for t in self._inputs]

    def get_input_handle(self, name):
        for t in self._inputs:
            if t.name == name:
                return t
        raise KeyError(name)

    def get_output_names(self):
        return [t.name for t in self._outputs] or ["output_0"]

    def get_output_handle(self, name):
        for t in self._outputs:
            if t.name == name:
                return t
        raise KeyError(name)

    def run(self, inputs=None):
        """Handle-style (``None``) or a direct list of arrays -> the
        outputs as numpy arrays."""
        if inputs is None:
            arrs = [t._value for t in self._inputs]
            if any(a is None for a in arrs):
                missing = [t.name for t in self._inputs if t._value is None]
                raise RuntimeError(f"inputs not set: {missing}")
        else:
            arrs = [a if isinstance(a, torch.Tensor) else np.asarray(a)
                    for a in inputs]
        outs = self._layer(*arrs)
        outs = outs if isinstance(outs, (list, tuple)) else [outs]
        self._outputs = []
        results = []
        for i, o in enumerate(outs):
            h = PredictorTensor(f"output_{i}")
            h._value = _numpy(o)
            self._outputs.append(h)
            results.append(h._value)
        return results


def create_predictor(config):
    """Reference: paddle_infer::CreatePredictor."""
    return Predictor(config)


class BatchingPredictor:
    """Dynamic batching over a :class:`Predictor` (reference: the serving
    path the inference engine feeds). Requests are queued, grouped up to
    ``max_batch_size`` (waiting at most ``max_wait_ms`` for stragglers),
    padded to the next bucket (``:227-244``) and run as one call, so each
    bucket is one captured graph on the card. ``close`` (also the context
    manager's exit) stops the worker and fails what is still queued."""

    def __init__(self, predictor, max_batch_size=8, max_wait_ms=2.0,
                 batch_buckets=None):
        self._pred = predictor
        self._buckets = sorted(batch_buckets or [1, 2, 4, max_batch_size])
        # a batch larger than the largest bucket has no captured shape
        self._max_b = min(max_batch_size, self._buckets[-1])
        self._wait_s = max_wait_ms / 1e3
        self._q: queue.Queue = queue.Queue()
        self._stop = False
        self._closed = False
        # guards the closed-check and enqueue against close's drain
        self._close_lock = threading.Lock()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def _bucket(self, n):
        return pick_bucket(n, self._buckets)

    def _loop(self):
        while not self._stop:
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self._wait_s
            while len(batch) < self._max_b:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            self._run_batch(batch)

    def _run_batch(self, batch):
        arrs = [np.asarray(req[0]) for req in batch]
        n = len(arrs)
        b = self._bucket(n)
        stacked = np.stack(arrs)
        if b > n:   # pad to the bucket: one captured shape per bucket
            pad = np.repeat(stacked[-1:], b - n, axis=0)
            stacked = np.concatenate([stacked, pad], axis=0)
        try:
            outs = self._pred.run([stacked])
            for i, (_, fut) in enumerate(batch):
                fut["result"] = [o[i] for o in outs]
                fut["event"].set()
        except Exception as e:   # every waiter gets the error
            for _, fut in batch:
                fut["error"] = e
                fut["event"].set()

    def predict(self, example, timeout=30.0):
        """Submit ONE example (no batch dim); blocks for its result."""
        fut = {"event": threading.Event(), "result": None, "error": None}
        with self._close_lock:
            if self._closed:
                raise RuntimeError("BatchingPredictor is closed")
            self._q.put((example, fut))
        if not fut["event"].wait(timeout):
            raise TimeoutError("BatchingPredictor request timed out")
        if fut["error"] is not None:
            raise fut["error"]
        res = fut["result"]
        return res[0] if len(res) == 1 else res

    def close(self, timeout=5.0):
        """Stop the worker and fail anything still queued; later
        ``predict`` calls fail fast. Idempotent."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self._stop = True
        self._worker.join(timeout=timeout)
        while True:
            try:
                _, fut = self._q.get_nowait()
            except queue.Empty:
                break
            fut["error"] = RuntimeError(
                "BatchingPredictor closed before the request ran")
            fut["event"].set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
