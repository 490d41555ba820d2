"""Fused AdamW — one multi-tensor CUDA launch and its plain PyTorch version.

Replaces ``paddle_tpu/ops/pallas/fused_adamw.py:60`` (``fused_adamw``):

* :func:`fused_adamw_reference` — the plain version of one tensor's
  update, exactly ``fused_adamw.py:32-47`` in f32: returns ``(w', m', v')``
  with w's type, m and v f32.
* :func:`fused_adamw` — the wrapper over a whole parameter list. On CUDA
  tensors it builds a device table of ``(w, g, m, v, n, lr, wd, bc1,
  bc2)`` per tensor and makes **one launch** of ``csrc/fused_adamw.cu``
  for the list (so an optimizer step launches it once), updating w, m and
  v in place; every launch adds one to ``fused_adamw.launches``. On CPU
  tensors it runs the plain version per tensor and copies the results in
  place. Anything else raises. The kernel is bound by bytes; see the
  source for its design.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

__all__ = ["fused_adamw_reference", "fused_adamw"]

# one table entry; must match ``struct Entry`` in csrc/fused_adamw.cu
_ENTRY = np.dtype([("w", "<u8"), ("g", "<u8"), ("m", "<u8"), ("v", "<u8"),
                   ("n", "<i8"), ("block0", "<i8"), ("lr", "<f4"),
                   ("wd", "<f4"), ("bc1", "<f4"), ("bc2", "<f4"),
                   ("w_bf16", "<i4"), ("g_bf16", "<i4")])
assert _ENTRY.itemsize == 72
_FLOATS = (torch.float32, torch.bfloat16)


def fused_adamw_reference(w, g, m, v, lr, b1, b2, eps, wd, bc1, bc2):
    """One tensor's AdamW update in f32 -> ``(w', m', v')``; w' keeps w's
    type, m' and v' are f32."""
    f = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    lr, b1, b2, eps, wd, bc1, bc2 = map(f, (lr, b1, b2, eps, wd, bc1, bc2))
    one = torch.tensor(1.0, dtype=torch.float32)
    gf = g.float()
    wf = w.float() * (one - lr * wd)
    m2 = b1 * m + (one - b1) * gf
    v2 = b2 * v + (one - b2) * gf * gf
    wf = wf - lr * (m2 * bc1) / (torch.sqrt(v2 * bc2) + eps)
    return wf.to(w.dtype), m2, v2


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


def fused_adamw(ws, gs, ms, vs, lr, b1, b2, eps, wd, bc1, bc2):
    """AdamW over the lists ``ws`` (params, f32 or bf16), ``gs`` (grads,
    f32 or bf16), ``ms``/``vs`` (f32 moments), in place. ``lr``, ``wd``,
    ``bc1`` and ``bc2`` are lists with one float per tensor; ``b1``,
    ``b2``, ``eps`` are shared. Launches per call: one on CUDA when the
    list holds an element, none on the CPU."""
    n = len(ws)
    if not (len(gs) == len(ms) == len(vs) == len(lr) == len(wd) == len(bc1)
            == len(bc2) == n):
        raise ValueError("ws, gs, ms, vs, lr, wd, bc1 and bc2 differ in "
                         "length")
    lrs, wds, c1s, c2s = ([float(a) for a in x] for x in (lr, wd, bc1, bc2))
    if n == 0:
        return
    dev = ws[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_adamw runs on cuda (kernel) or cpu (plain "
                         f"version), not {dev}")
    for i, (w, g, m, v) in enumerate(zip(ws, gs, ms, vs)):
        if w.dtype not in _FLOATS or g.dtype not in _FLOATS:
            raise TypeError(f"tensor {i}: w {w.dtype} / g {g.dtype}; "
                            f"float32 or bfloat16 expected")
        if m.dtype != torch.float32 or v.dtype != torch.float32:
            raise TypeError(f"tensor {i}: moments must be float32")
        if not (w.shape == g.shape == m.shape == v.shape):
            raise ValueError(f"tensor {i}: shapes {tuple(w.shape)}, "
                             f"{tuple(g.shape)}, {tuple(m.shape)}, "
                             f"{tuple(v.shape)} differ")
        for x in (w, g, m, v):
            if x.device != dev:
                raise ValueError(f"tensor {i} is on {x.device}, not {dev}")
            if dev.type == "cuda" and not x.is_contiguous():
                raise ValueError(f"tensor {i} must be contiguous")
    if dev.type == "cpu":
        with torch.no_grad():
            for w, g, m, v, lr_i, wd_i, c1, c2 in zip(ws, gs, ms, vs, lrs,
                                                      wds, c1s, c2s):
                w2, m2, v2 = fused_adamw_reference(w, g, m, v, lr_i, b1, b2,
                                                   eps, wd_i, c1, c2)
                w.copy_(w2)
                m.copy_(m2)
                v.copy_(v2)
        return
    fn, chunk = _kernel()
    live = [i for i in range(n) if ws[i].numel()]
    if not live:
        return
    table = np.zeros(len(live), _ENTRY)
    block = 0
    for row, i in enumerate(live):
        w, g = ws[i], gs[i]
        table[row] = (w.data_ptr(), g.data_ptr(), ms[i].data_ptr(),
                      vs[i].data_ptr(), w.numel(), block, lrs[i], wds[i],
                      c1s[i], c2s[i], int(w.dtype == torch.bfloat16),
                      int(g.dtype == torch.bfloat16))
        block += -(-w.numel() // chunk)
    dtable = torch.from_numpy(table.view(np.uint8)).to(dev)
    rc = fn(dtable.data_ptr(), len(live), block, float(b1), float(b2),
            float(eps), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_adamw kernel launch failed: cudaError "
                           f"{rc}")
    fused_adamw.launches += 1


fused_adamw.launches = 0
