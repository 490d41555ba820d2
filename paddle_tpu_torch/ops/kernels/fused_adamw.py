"""Fused AdamW — one multi-tensor CUDA launch and its plain PyTorch version.

Replaces ``paddle_tpu/ops/pallas/fused_adamw.py:60`` (``fused_adamw``):

* :func:`fused_adamw_reference` — the plain version of one tensor's
  update, exactly ``fused_adamw.py:32-47`` in f32: returns ``(w', m', v')``
  with the types of w, m and v (a bf16 result rounded to nearest even).
* :func:`fused_adamw` — the wrapper over a whole parameter list. On CUDA
  tensors it builds a device table of ``(w, g, m, v, p, n, lr, wd, bc1,
  bc2)`` per tensor and makes **one launch** of ``csrc/fused_adamw.cu``
  for the list (so an optimizer step launches it once, whatever mix of
  modes it holds), updating w, m and v in place; every launch adds one to
  ``fused_adamw.launches``. On CPU tensors it runs the plain version per
  tensor and copies the results in place. Anything else raises. The
  kernel is bound by bytes; see the source for its design.

Each entry is in one of three modes:

* w f32 or bf16 with f32 moments (f32 training and O1);
* **master mode** (O2 with ``multi_precision``): w is the f32 master of
  the bf16 parameter ``params[i]``, the moments are f32, and the same pass
  writes ``params[i] = bf16(w')``;
* **bf16 moments** (O2 without master weights): w, m and v are bf16,
  updated in f32 and stored rounded.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

__all__ = ["fused_adamw_reference", "fused_adamw"]

# one table entry; must match ``struct Entry`` in csrc/fused_adamw.cu
_ENTRY = np.dtype([("w", "<u8"), ("g", "<u8"), ("m", "<u8"), ("v", "<u8"),
                   ("p", "<u8"), ("n", "<i8"), ("block0", "<i8"),
                   ("lr", "<f4"), ("wd", "<f4"), ("bc1", "<f4"),
                   ("bc2", "<f4"), ("w_bf16", "<i4"), ("g_bf16", "<i4"),
                   ("mv_bf16", "<i4"), ("pad", "<i4")])
assert _ENTRY.itemsize == 88
_FLOATS = (torch.float32, torch.bfloat16)


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
    if w.dtype not in _FLOATS or g.dtype not in _FLOATS:
        raise TypeError(f"tensor {i}: w {w.dtype} / g {g.dtype}; float32 "
                        f"or bfloat16 expected")
    if m.dtype not in _FLOATS or v.dtype != m.dtype:
        raise TypeError(f"tensor {i}: moments {m.dtype} / {v.dtype}; both "
                        f"float32 or both bfloat16 expected")
    if p is not None and (p.dtype != torch.bfloat16
                          or w.dtype != torch.float32
                          or m.dtype != torch.float32):
        raise TypeError(f"tensor {i}: master mode takes an f32 w and f32 "
                        f"moments for a bf16 parameter, got w {w.dtype}, "
                        f"m {m.dtype}, parameter {p.dtype}")
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


def fused_adamw(ws, gs, ms, vs, lr, b1, b2, eps, wd, bc1, bc2, params=None):
    """AdamW over the lists ``ws`` (params or f32 masters, f32 or bf16),
    ``gs`` (grads, f32 or bf16), ``ms``/``vs`` (moments, f32 or bf16), in
    place. ``params``, if given, holds for each entry None or the bf16
    parameter whose f32 master is ``ws[i]`` (master mode: it is written
    with ``bf16(w')`` in the same pass). ``lr``, ``wd``, ``bc1`` and
    ``bc2`` are lists with one float per tensor; ``b1``, ``b2``, ``eps``
    are shared. Launches per call: one on CUDA when the list holds an
    element, none on the CPU."""
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
    plan = _table(ws, gs, ms, vs, params, lrs, wds, c1s, c2s, chunk)
    if plan is not None:
        _launch(fn, plan, b1, b2, eps)
        fused_adamw.launches += 1


def _table(ws, gs, ms, vs, params, lrs, wds, c1s, c2s, chunk):
    """The launch's device table over the non-empty tensors -> ``(table,
    rows, blocks)``, or None when every tensor is empty."""
    live = [i for i in range(len(ws)) if ws[i].numel()]
    if not live:
        return None
    bf16 = torch.bfloat16
    table = np.zeros(len(live), _ENTRY)
    block = 0
    for row, i in enumerate(live):
        w, g, m, p = ws[i], gs[i], ms[i], params[i]
        table[row] = (w.data_ptr(), g.data_ptr(), m.data_ptr(),
                      vs[i].data_ptr(), 0 if p is None else p.data_ptr(),
                      w.numel(), block, lrs[i], wds[i], c1s[i], c2s[i],
                      int(w.dtype == bf16), int(g.dtype == bf16),
                      int(m.dtype == bf16), 0)
        block += -(-w.numel() // chunk)
    dtable = torch.from_numpy(table.view(np.uint8)).to(ws[0].device)
    return dtable, len(live), block


def _launch(fn, plan, b1, b2, eps):
    """One launch of the kernel over a :func:`_table` plan."""
    dtable, rows, blocks = plan
    rc = fn(dtable.data_ptr(), rows, blocks, float(b1), float(b2),
            float(eps), torch.cuda.current_stream(dtable.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_adamw kernel launch failed: cudaError "
                           f"{rc}")


fused_adamw.launches = 0
