"""One program per round shape: the port's counterpart of ``jax.jit``.

The JAX engine runs each scheduler round as one compiled program,
specialised per shape: the ragged round per padded token count
(``paddle_tpu/serving/engine.py`` ``_build_ragged_step``), the bucketed
engine's dense prefill and chunk step per (batch, seq) bucket
(``_build_prefill``, ``_build_chunk_prefill``) and its fixed-slot decode
step (``_build_step``). Here a :class:`RoundProgram` plays that part for
one shape key. It holds

* a static device input: the round's flat int32 metadata, rewritten in
  full every round, sentinels included, so a small pad that follows a
  large one never reads a stale entry;
* a host staging buffer that the host fills, and host output buffers that
  the results come back to (both pinned on CUDA);
* on CUDA, one ``torch.cuda.CUDAGraph`` of the round's forward
  (:func:`capture`: after one eager warm-up run, which builds and loads
  the kernels, compiles the Triton ones and sets up cuBLAS for this
  thread and stream outside the capture).

A round then costs one host-to-device copy (staging to static input), one
``graph.replay()`` and one asynchronous device-to-host copy waited on by
an event. On the CPU, which has no graphs, the same static-buffer round
runs the forward eagerly with the kernels' plain versions.

Invariants:

* The graphs of one :class:`RoundPrograms` share one memory pool
  (``torch.cuda.graph_pool_handle()``), captured largest first. One
  graph's intermediates may overlap another's. That is safe because rounds
  run one at a time on one stream and each round's outputs are copied to
  the host, and waited on, before the next replay starts; each graph's
  static outputs stay referenced, so no later capture reuses them.
* Everything a graph reads or writes outside its pool (weights, the KV
  pools, the static input, the split scratch) is owned by the engine for
  the graph's lifetime and never reallocated.
* The host overwrites a round's staging buffer only after the previous
  round's fetch event has completed. That event follows the previous
  host-to-device copy on the same stream, so the copy has read the buffer
  by then.
* A replay does not run the kernel wrappers, so each capture records the
  launches its wrappers counted and every replay adds them to the counts
  (``ops.kernels.add_launch_counts``); the capture itself launched
  nothing and takes its counts back. The counts are process-wide, so a
  capture takes as its own whatever another thread launches through the
  wrappers meanwhile: capture while no other thread launches them.

The compiled ``generate`` (``models/generate.py``) captures its decode
step with :func:`capture` under the same invariants.

A capture or a replay that fails raises; nothing falls back to the eager
round.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..ops import kernels as _K

__all__ = ["Captured", "RoundProgram", "RoundPrograms", "capture",
           "capture_stream"]

_streams: dict = {}
# one capture at a time in the process (engines' serve threads may each
# meet a new pad at once), and one warm-up at a time on the shared stream
_capture_lock = threading.Lock()


def capture_stream(device):
    """The one stream every program on ``device`` warms up and captures
    on. cuBLAS keeps a workspace for each stream it has run on for the
    life of the process, so one stream for all engines holds one."""
    if device not in _streams:
        _streams[device] = torch.cuda.Stream(device)
    return _streams[device]


class Captured:
    """One captured CUDA graph, its static outputs and the kernel launches
    a replay issues."""

    def __init__(self, graph, outputs, launches):
        self.graph = graph
        self.outputs = outputs
        self.launches = launches

    def replay(self):
        """Replay the graph, add its launches to the counts -> its static
        outputs."""
        self.graph.replay()
        _K.add_launch_counts(self.launches)
        return self.outputs


def capture(fn, pool, stream):
    """Run ``fn()`` once eagerly on ``stream`` (the warm-up: its work is
    done for real), then capture ``fn()`` into a graph on ``stream``
    drawing from ``pool`` -> :class:`Captured`. The capture launches
    nothing, so it takes back the launches its wrappers counted."""
    with _capture_lock:
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream), torch.no_grad():
            fn()
        torch.cuda.current_stream().wait_stream(stream)
        before = _K.launch_counts()
        graph = torch.cuda.CUDAGraph()
        # thread_local: the serve thread may capture a new shape while
        # other threads submit requests
        with torch.no_grad(), torch.cuda.graph(
                graph, pool=pool, stream=stream,
                capture_error_mode="thread_local"):
            outputs = fn()
        after = _K.launch_counts()
    launches = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
    _K.add_launch_counts({k: -n for k, n in launches.items()})
    return Captured(graph, outputs, launches)


class RoundProgram:
    """One shape key's round over ``n_inputs`` int32 of metadata. The
    forward ``fn(static_in) -> (next tokens [R], f32 logit rows [R, V])``
    is passed to each call and kept by none."""

    def __init__(self, n_inputs, device):
        cuda = device.type == "cuda"
        self._pin = cuda
        self.staging = torch.empty(n_inputs, dtype=torch.int32,
                                   pin_memory=cuda)
        self._staging_np = self.staging.numpy()
        self.static_in = torch.zeros(n_inputs, dtype=torch.int32,
                                     device=device)
        self.captured = None   # the graph (CUDA), once captured
        self._host = None      # host (tokens, rows) buffers
        self._event = torch.cuda.Event() if cuda else None

    def stage(self, parts):
        """Write every entry of the static input: ``parts`` (int arrays,
        flattened in order) into the staging buffer, then one copy to the
        device. The previous round's fetch has been waited on, so its copy
        of the staging buffer is done."""
        np.concatenate([np.ravel(p) for p in parts], out=self._staging_np)
        self.static_in.copy_(self.staging, non_blocking=True)

    def capture(self, fn, pool, stream):
        """Capture ``fn`` over the static input (:func:`capture`)."""
        self.captured = capture(lambda: fn(self.static_in), pool, stream)

    def execute(self, fn):
        """The round on the staged input -> its device outputs: a replay
        when captured, else ``fn`` eagerly."""
        if self.captured is None:
            with torch.no_grad():
                return fn(self.static_in)
        return self.captured.replay()

    def fetch(self, outputs, need_rows):
        """One asynchronous copy of the round's tokens, or of its f32
        logit rows when ``need_rows``, into a host buffer, waited on by an
        event -> ``(next tokens, logit rows or None)`` (the greedy tokens
        are the rows' argmax on the host when rows are fetched)."""
        tok, rows = outputs
        if self._host is None:
            self._host = tuple(torch.empty(t.shape, dtype=t.dtype,
                                           pin_memory=self._pin)
                               for t in (tok, rows))
        src, dst = (rows, self._host[1]) if need_rows \
            else (tok, self._host[0])
        dst.copy_(src, non_blocking=True)
        if self._event is not None:
            self._event.record()
            self._event.synchronize()
        if need_rows:
            rows_np = dst.numpy().copy()
            return rows_np.argmax(axis=-1).tolist(), rows_np
        return dst.numpy().tolist(), None


class RoundPrograms:
    """An engine's programs, one per shape key, and what they cost: on a
    CUDA ``device`` each is captured as a graph at its first round, all
    in one memory pool; on the CPU each runs eagerly over its static
    buffers. ``host_s`` sums the host seconds of the program calls
    (staging copy and replay, or the eager forward) and of the waits on
    their fetches; ``capture_s`` the seconds spent warming up and
    capturing."""

    def __init__(self, device):
        self.device = device
        self.capture = device.type == "cuda"
        self._pool = torch.cuda.graph_pool_handle() if self.capture \
            else None
        self._stream = capture_stream(device) if self.capture else None
        self._progs: dict = {}
        self.capture_s = 0.0
        self.host_s = {"call": 0.0, "wait": 0.0}

    @property
    def graphs(self):
        return sum(p.captured is not None for p in self._progs.values())

    def run(self, key, fn, parts, need_rows):
        """One round of ``key``'s program over the metadata ``parts`` ->
        ``(next tokens, logit rows or None)``. The first round of a key
        creates its buffers and, on CUDA, captures its graph."""
        prog = self._progs.get(key)
        if prog is None:
            prog = RoundProgram(sum(np.size(p) for p in parts), self.device)
            self._progs[key] = prog
        t0 = time.perf_counter()
        prog.stage(parts)
        if self.capture and prog.captured is None:
            prog.capture(fn, self._pool, self._stream)
            t1 = time.perf_counter()
            self.capture_s += t1 - t0
            t0 = t1
        outputs = prog.execute(fn)
        t1 = time.perf_counter()
        out = prog.fetch(outputs, need_rows)
        self.host_s["call"] += t1 - t0
        self.host_s["wait"] += time.perf_counter() - t1
        return out

    def clear(self):
        """Drop every program: their graphs free their pool."""
        self._progs.clear()
