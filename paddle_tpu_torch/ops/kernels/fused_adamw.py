"""Fused AdamW — one multi-tensor CUDA launch and its plain PyTorch version.

Replaces ``paddle_tpu/ops/pallas/fused_adamw.py:60`` (``fused_adamw``):

* :func:`fused_adamw_reference` — the plain version of one tensor's
  update, exactly ``fused_adamw.py:32-47`` in f32: returns ``(w', m', v')``
  with the types of w, m and v (a 16-bit result rounded to nearest even).
* :func:`fused_adamw` — the wrapper over a whole parameter list. On CUDA
  tensors it builds a device table of ``(w, g, m, v, p, n, lr, wd, bc1,
  bc2)`` per tensor and makes **one launch** of ``csrc/fused_adamw.cu``
  for the list (so an optimizer step launches it once, whatever mix of
  modes it holds), updating w, m and v in place; every launch adds one to
  ``fused_adamw.launches``. On CPU tensors it runs the plain version per
  tensor and copies the results in place. Anything else raises. The
  kernel is bound by bytes; see the source for its design.

Each entry is in one of three modes:

* w f32, bf16 or f16 with f32 moments (f32 training and O1);
* **master mode** (O2 with ``multi_precision``): w is the f32 master of
  the bf16 or f16 parameter ``params[i]``, the moments are f32, and the
  same pass writes ``params[i]`` = w' rounded to its type;
* **16-bit moments** (O2 without master weights): w, m and v are bf16 (or
  f16), updated in f32 and stored rounded.

The table carries each tensor's types as codes (:data:`TYPE_CODES`: 0
f32, 1 bf16, 2 f16), which the kernel loads and stores by.

A call builds its table in numpy and copies it to the card from pageable
memory, which a CUDA graph cannot capture, and which would bake the
step's lr and bias corrections into it. A staged training step
(``jit.to_static``) passes an :class:`AdamWTable` instead: a static device
table, allocated at the step's eager first call, whose pointer fields the
capture fills (the tensors the graph replays) and whose float fields the
host rewrites before each replay (:meth:`AdamWTable.set_scalars`), then
copies in with one non-blocking copy from pinned memory
(:meth:`AdamWTable.upload`), as ``serving/compiled.py``'s
``RoundProgram.stage`` rewrites its static input. The launch inside the
graph reads the table from the device.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

__all__ = ["fused_adamw_reference", "fused_adamw", "AdamWTable",
           "TYPE_CODES"]

# one table entry; must match ``struct Entry`` in csrc/fused_adamw.cu
_ENTRY = np.dtype([("w", "<u8"), ("g", "<u8"), ("m", "<u8"), ("v", "<u8"),
                   ("p", "<u8"), ("n", "<i8"), ("block0", "<i8"),
                   ("lr", "<f4"), ("wd", "<f4"), ("bc1", "<f4"),
                   ("bc2", "<f4"), ("w_type", "<i4"), ("g_type", "<i4"),
                   ("mv_type", "<i4"), ("p_type", "<i4")])
assert _ENTRY.itemsize == 88
# the kernel's type codes (kF32, kBF16, kF16 in csrc/fused_adamw.cu)
TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HALVES = (torch.bfloat16, torch.float16)


def fused_adamw_reference(w, g, m, v, lr, b1, b2, eps, wd, bc1, bc2):
    """One tensor's AdamW update in f32 -> ``(w', m', v')`` in the types of
    w, m and v."""
    f = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    lr, b1, b2, eps, wd, bc1, bc2 = map(f, (lr, b1, b2, eps, wd, bc1, bc2))
    one = torch.tensor(1.0, dtype=torch.float32)
    gf = g.float()
    wf = w.float() * (one - lr * wd)
    m2 = b1 * m.float() + (one - b1) * gf
    v2 = b2 * v.float() + (one - b2) * gf * gf
    wf = wf - lr * (m2 * bc1) / (torch.sqrt(v2 * bc2) + eps)
    return wf.to(w.dtype), m2.to(m.dtype), v2.to(v.dtype)


_lib = {}


def _kernel():
    if not _lib:
        from . import _build
        lib = _build.load("fused_adamw")
        fn = lib.fused_adamw
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float, ctypes.c_float, ctypes.c_float,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.fused_adamw_chunk.restype = ctypes.c_int
        _lib["fn"], _lib["chunk"] = fn, lib.fused_adamw_chunk()
    return _lib["fn"], _lib["chunk"]


def _check(i, w, g, m, v, p, dev):
    if w.dtype not in TYPE_CODES or g.dtype not in TYPE_CODES:
        raise TypeError(f"tensor {i}: w {w.dtype} / g {g.dtype}; float32, "
                        f"bfloat16 or float16 expected")
    if m.dtype not in TYPE_CODES or v.dtype != m.dtype:
        raise TypeError(f"tensor {i}: moments {m.dtype} / {v.dtype}; both "
                        f"float32, both bfloat16 or both float16 expected")
    if p is not None and (p.dtype not in _HALVES
                          or w.dtype != torch.float32
                          or m.dtype != torch.float32):
        raise TypeError(f"tensor {i}: master mode takes an f32 w and f32 "
                        f"moments for a bf16 or f16 parameter, got w "
                        f"{w.dtype}, m {m.dtype}, parameter {p.dtype}")
    shapes = [tuple(x.shape) for x in (w, g, m, v, p) if x is not None]
    if len(set(shapes)) != 1:
        raise ValueError(f"tensor {i}: shapes {shapes} differ")
    for x in (w, g, m, v, p):
        if x is None:
            continue
        if x.device != dev:
            raise ValueError(f"tensor {i} is on {x.device}, not {dev}")
        if dev.type == "cuda" and not x.is_contiguous():
            raise ValueError(f"tensor {i} must be contiguous")


def fused_adamw(ws, gs, ms, vs, lr, b1, b2, eps, wd, bc1, bc2, params=None,
                table=None):
    """AdamW over the lists ``ws`` (params or f32 masters, f32, bf16 or
    f16), ``gs`` (grads, any of the three), ``ms``/``vs`` (moments, f32 or
    the 16-bit type of their w), in place. ``params``, if given, holds for
    each entry None or the bf16 or f16 parameter whose f32 master is
    ``ws[i]`` (master mode: it is written with w' rounded to its type in
    the same pass). ``lr``, ``wd``, ``bc1`` and
    ``bc2`` are lists with one float per tensor; ``b1``, ``b2``, ``eps``
    are shared. On CUDA, ``table`` (an :class:`AdamWTable`) holds the
    launch's table instead of a new one: it is filled from these tensors
    and, unless the stream is capturing, uploaded. Launches per call: one
    on CUDA when the list holds an element, none on the CPU."""
    n = len(ws)
    if params is None:
        params = [None] * n
    if not (len(gs) == len(ms) == len(vs) == len(lr) == len(wd) == len(bc1)
            == len(bc2) == len(params) == n):
        raise ValueError("ws, gs, ms, vs, lr, wd, bc1, bc2 and params "
                         "differ in length")
    lrs, wds, c1s, c2s = ([float(a) for a in x] for x in (lr, wd, bc1, bc2))
    if n == 0:
        return
    dev = ws[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_adamw runs on cuda (kernel) or cpu (plain "
                         f"version), not {dev}")
    for i, x in enumerate(zip(ws, gs, ms, vs, params)):
        _check(i, *x, dev)
    if dev.type == "cpu":
        with torch.no_grad():
            for w, g, m, v, p, lr_i, wd_i, c1, c2 in zip(
                    ws, gs, ms, vs, params, lrs, wds, c1s, c2s):
                w2, m2, v2 = fused_adamw_reference(w, g, m, v, lr_i, b1, b2,
                                                   eps, wd_i, c1, c2)
                w.copy_(w2)
                m.copy_(m2)
                v.copy_(v2)
                if p is not None:
                    p.copy_(w2)
        return
    fn, chunk = _kernel()
    if table is not None:
        table.fill(ws, gs, ms, vs, params, chunk)
        table.set_scalars(lrs, wds, c1s, c2s)
        if not torch.cuda.is_current_stream_capturing():
            table.upload()
        plan = table.plan()
    else:
        plan = _table(ws, gs, ms, vs, params, lrs, wds, c1s, c2s, chunk)
    if plan is not None:
        _launch(fn, plan, b1, b2, eps)
        fused_adamw.launches += 1


def _entries(ws, gs, ms, vs, params, chunk):
    """-> (numpy table over the non-empty tensors with every field but the
    floats, their indices, the blocks the launch takes)."""
    live = [i for i in range(len(ws)) if ws[i].numel()]
    code = TYPE_CODES
    table = np.zeros(len(live), _ENTRY)
    block = 0
    for row, i in enumerate(live):
        w, g, m, p = ws[i], gs[i], ms[i], params[i]
        table[row] = (w.data_ptr(), g.data_ptr(), m.data_ptr(),
                      vs[i].data_ptr(), 0 if p is None else p.data_ptr(),
                      w.numel(), block, 0.0, 0.0, 0.0, 0.0,
                      code[w.dtype], code[g.dtype], code[m.dtype],
                      0 if p is None else code[p.dtype])
        block += -(-w.numel() // chunk)
    return table, live, block


def _set_floats(table, live, lrs, wds, c1s, c2s):
    for field, vals in (("lr", lrs), ("wd", wds), ("bc1", c1s),
                        ("bc2", c2s)):
        table[field] = [vals[i] for i in live]


def _table(ws, gs, ms, vs, params, lrs, wds, c1s, c2s, chunk):
    """The launch's device table over the non-empty tensors -> ``(table,
    rows, blocks)``, or None when every tensor is empty."""
    table, live, blocks = _entries(ws, gs, ms, vs, params, chunk)
    if not live:
        return None
    _set_floats(table, live, lrs, wds, c1s, c2s)
    dtable = torch.from_numpy(table.view(np.uint8)).to(ws[0].device)
    return dtable, len(live), blocks


class AdamWTable:
    """One launch's table kept across calls (a staged step's): the device
    table the kernel reads, a host copy of it, and two pinned buffers that
    take turns carrying it to the card. Allocated by the first
    :meth:`fill`, which must not run under a capture; a later fill (the
    capture's) must name as many non-empty tensors."""

    def __init__(self):
        self.dev = None
        self._np = None          # the host table (numpy, _ENTRY rows)
        self._live = None        # indices of the tensors the rows hold
        self._blocks = 0
        self._pinned = []        # [(pinned uint8 buffer, event)] x 2
        self._turn = 0

    def fill(self, ws, gs, ms, vs, params, chunk):
        """Write every row's pointers, sizes, blocks and type codes from
        these tensors (under a capture: the ones the graph replays)."""
        table, live, blocks = _entries(ws, gs, ms, vs, params, chunk)
        if self.dev is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("an AdamWTable is allocated by an eager "
                                   "call before it is captured")
            dev = ws[0].device
            self.dev = torch.empty(table.nbytes, dtype=torch.uint8,
                                   device=dev)
            self._pinned = [(torch.empty(table.nbytes, dtype=torch.uint8,
                                         pin_memory=True), torch.cuda.Event())
                            for _ in range(2)]
        elif table.nbytes != self.dev.numel():
            raise ValueError(f"the table holds {self.dev.numel() // 88} "
                             f"rows; this call has {len(live)}")
        self._np, self._live, self._blocks = table, live, blocks

    def set_scalars(self, lrs, wds, c1s, c2s):
        """Rewrite the rows' lr, wd, bc1 and bc2 on the host (one float per
        tensor of the filled lists, empty ones included)."""
        _set_floats(self._np, self._live, lrs, wds, c1s, c2s)

    def upload(self):
        """One non-blocking copy of the host table to the device table on
        the current stream. The pinned buffer it goes through was last read
        by the copy two uploads ago, which its event waits for."""
        pinned, event = self._pinned[self._turn]
        self._turn ^= 1
        event.synchronize()
        pinned.numpy()[:] = self._np.view(np.uint8)
        self.dev.copy_(pinned, non_blocking=True)
        event.record()

    def plan(self):
        """-> ``(device table, rows, blocks)`` for :func:`_launch`, or None
        when every tensor is empty."""
        return (self.dev, len(self._live), self._blocks) if self._live \
            else None


def _launch(fn, plan, b1, b2, eps):
    """One launch of the kernel over a :func:`_table` plan."""
    dtable, rows, blocks = plan
    rc = fn(dtable.data_ptr(), rows, blocks, float(b1), float(b2),
            float(eps), torch.cuda.current_stream(dtable.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_adamw kernel launch failed: cudaError "
                           f"{rc}")


fused_adamw.launches = 0
