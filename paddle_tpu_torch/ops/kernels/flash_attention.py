"""Flash attention, forward and backward — three CUDA kernels and their
plain PyTorch versions.

The port of ``paddle_tpu/ops/pallas/flash_attention.py``:

* the plain versions, in the JAX kernels' layout (``[B*H, S, D]``; lse and
  delta ``[B*H, S]`` f32), one per kernel: :func:`flash_fwd_reference`
  (``_flash_fwd``, :106), :func:`flash_bwd_dq_reference`
  (``_bwd_dq_kernel``, :143) and :func:`flash_bwd_dkv_reference`
  (``_bwd_dkv_kernel``, :193). Keys count where ``kpos < kv_len`` and, when
  causal, ``kpos <= qpos``; masked scores are ``-1e30`` (:69-77) and add
  exactly nothing; all three compute in f32 and return the input's type.
* the wrappers of the CUDA kernels on ``[B, S, H, D]`` tensors read
  through their strides (lse and delta ``[B, H, S]`` f32):
  :func:`flash_fwd`, :func:`flash_bwd_dq`, :func:`flash_bwd_dkv`. bf16
  and f16 launch ``csrc/flash_attention_sm90.cu`` (wgmma, TMA, warp
  specialisation; one instantiation per type), f32
  ``csrc/flash_attention.cu``. On a CPU tensor each
  runs its plain version; on a CUDA tensor it launches its kernel or
  raises, and counts the launch. See the sources for their designs and bounds.
* ``_FlashAttention`` — the differentiable form, with the semantics of
  ``flash_attention.py:368-393``: forward kernel, then the backward
  computes ``delta = rowsum(dO * O)`` (:256) and runs the dQ and dK/dV
  kernels. The S tail is masked in the kernels rather than padded. Its
  entry point, ``flash_attention_bshd``, is in ``library.py``, which
  takes the ``flash_fwd`` op instead in a traced program.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["flash_fwd_reference", "flash_bwd_dq_reference",
           "flash_bwd_dkv_reference", "flash_fwd", "flash_bwd_dq",
           "flash_bwd_dkv", "flash_delta"]

NEG_INF = -1e30
# the kernels' type codes: 0 runs flash_attention.cu, 1 and 2 the sm90 file
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


# ------------------------------------------------------- plain versions
def _scores(q, k, scale, causal, kv_len):
    """f32 scores ``[BH, Sq, Sk]`` and the mask of keys that count."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    sq, sk = q.shape[1], k.shape[1]
    kv_len = sk if kv_len is None else kv_len
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    valid = kpos < kv_len
    if causal:
        valid = valid & (kpos <= qpos)
    return torch.where(valid, s, torch.full_like(s, NEG_INF)), valid


def _probs(q, k, lse, scale, causal, kv_len):
    s, valid = _scores(q, k, scale, causal, kv_len)
    return torch.where(valid, torch.exp(s - lse[..., None]),
                       torch.zeros_like(s))


def flash_fwd_reference(q, k, v, scale, causal, kv_len=None):
    """``q`` [BH, Sq, D], ``k``/``v`` [BH, Sk, D] -> ``(O, lse)``: O in
    q's type, lse [BH, Sq] f32 (``m + log(l)``, l floored at 1e-30, so a
    row with no valid key gives O = 0 and lse ~ -1e30)."""
    s, valid = _scores(q, k, scale, causal, kv_len)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bqk,bkd->bqd", p, v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_bwd_dq_reference(q, k, v, do, lse, delta, scale, causal,
                           kv_len=None):
    """``dQ = sum_k dS K`` with ``dS = P * (dO V^T - delta) * scale`` and
    P recomputed from ``lse`` -> dQ in q's type."""
    p = _probs(q, k, lse, scale, causal, kv_len)
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    ds = p * (dp - delta[..., None]) * scale
    return torch.einsum("bqk,bkd->bqd", ds, k.float()).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, scale, causal,
                            kv_len=None):
    """``dV = P^T dO``, ``dK = dS^T Q`` -> ``(dK, dV)`` in k's and v's
    types."""
    p = _probs(q, k, lse, scale, causal, kv_len)
    dof = do.float()
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    dp = torch.einsum("bqd,bkd->bqk", dof, v.float())
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------- layout
def _to_bhsd(x):
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d)


def _to_bshd(x, b, h):
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).transpose(1, 2).contiguous()


def flash_delta(o, do):
    """``delta = rowsum(dO * O)`` in f32 (``flash_attention.py:256``):
    [B, S, H, D] -> [B, H, S]."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


# -------------------------------------------------------------- kernels
_fns = {}
# C entry point -> (library, pointer arguments); every entry then takes
# the meta array, scale, causal, the type code and the stream
_ENTRIES = {"flash_attention_fwd": ("flash_attention", 5),
            "flash_attention_bwd_dq": ("flash_attention", 7),
            "flash_attention_bwd_dkv": ("flash_attention", 8),
            "flash_attention_sm90_fwd": ("flash_attention_sm90", 5),
            "flash_attention_sm90_bwd_dq": ("flash_attention_sm90", 7),
            "flash_attention_sm90_bwd_dkv": ("flash_attention_sm90", 8)}


def _kernel(name):
    fn = _fns.get(name)
    if fn is None:
        from . import _build
        lib, n_ptr = _ENTRIES[name]
        fn = getattr(_build.load(lib), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _readable(x):
    """Whether the kernels can read ``x`` [B, S, H, D] in place: 16-byte
    rows (base and strides; the f32 kernels load 16-byte vectors, the bf16
    kernels' TMA maps require them) and head, sequence and batch strides
    that grow in that order, dimensions of extent 1 aside (the order of the
    TMA map's dimensions)."""
    v = 16 // x.element_size()
    if not (x.stride(3) == 1 and x.data_ptr() % 16 == 0
            and all(x.stride(i) % v == 0 for i in range(3))):
        return False
    grow = [x.stride(i) for i in (2, 1, 0) if x.shape[i] > 1]
    return grow == sorted(grow)


def _prepare(name, q, k, v, do=None):
    """Check what the kernels take -> the four [B, S, H, D] operands
    (re-laid out contiguous only where :func:`_readable` refuses them) and
    the host meta array (B, H, Sq, Sk, D and their strides)."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32, bfloat16 or float16, got "
                        f"{q.dtype}")
    ops = [("q", q), ("k", k), ("v", v)] + ([("do", do)] if do is not None
                                            else [])
    for n, x in ops:
        if x.dtype != q.dtype:
            raise TypeError(f"{n} is {x.dtype}, q is {q.dtype}")
        if x.device != q.device:
            raise ValueError(f"{n} is on {x.device}, q on {q.device}")
        if x.dim() != 4:
            raise ValueError(f"{n} must be [B, S, H, D], got "
                             f"{tuple(x.shape)}")
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if D > 128 or D % 16:
        raise ValueError(f"head dim {D} not supported (a multiple of 16, "
                         f"at most 128)")
    if k.shape != (B, Sk, H, D) or v.shape != k.shape or Sq == 0 or Sk == 0:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not match")
    if do is not None and do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} does not match q")
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the grid's 65535")
    ts = [x if _readable(x) else x.contiguous() for _, x in ops]
    strides = [s for x in ts + [ts[0]] * (4 - len(ts))
               for s in (x.stride(0), x.stride(1), x.stride(2))]
    meta = (ctypes.c_longlong * 17)(B, H, Sq, Sk, D, *strides)
    return ts, meta


def _check_rows(name, t, B, H, S, q):
    if t.dtype != torch.float32 or t.shape != (B, H, S) \
            or not t.is_contiguous() or t.device != q.device:
        raise ValueError(f"{name} must be a contiguous f32 [{B}, {H}, {S}] "
                         f"tensor on {q.device}")


def _on_cuda(name, q):
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda (kernel) or cpu (plain "
                         f"version), not {q.device}")
    return True


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _entry(kind, q):
    """The C entry of ``kind`` (fwd, bwd_dq, bwd_dkv) for q's type: the
    Hopper kernels for bf16 and f16, the f32 library for f32."""
    sm90 = "_sm90" if q.dtype != torch.float32 else ""
    return f"flash_attention{sm90}_{kind}"


def _raise_if(rc, name):
    if rc == -1:
        raise RuntimeError(f"{name}: the driver refused a TMA tensor map")
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def flash_fwd(q, k, v, scale, causal):
    """``q`` [B, Sq, H, D], ``k``/``v`` [B, Sk, H, D] -> ``(O, lse)``: O
    contiguous [B, Sq, H, D] in q's type, lse [B, H, Sq] f32. Every
    kernel launch adds one to ``flash_fwd.launches``."""
    B, Sq, H, D = q.shape
    if not _on_cuda("flash_fwd", q):
        o, lse = flash_fwd_reference(_to_bhsd(q), _to_bhsd(k), _to_bhsd(v),
                                     scale, causal)
        return _to_bshd(o, B, H), lse.reshape(B, H, Sq)
    (q, k, v), meta = _prepare("flash_fwd", q, k, v)
    o = torch.empty(B, Sq, H, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), meta, float(scale), int(bool(causal)))
    rc = _kernel(_entry("fwd", q))(*args, _DTYPES[q.dtype], _stream())
    _raise_if(rc, "flash_fwd")
    flash_fwd.launches += 1
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, scale, causal):
    """-> dQ, contiguous [B, Sq, H, D] in q's type. Every kernel launch
    adds one to ``flash_bwd_dq.launches``."""
    B, Sq, H, D = q.shape
    if not _on_cuda("flash_bwd_dq", q):
        dq = flash_bwd_dq_reference(
            _to_bhsd(q), _to_bhsd(k), _to_bhsd(v), _to_bhsd(do),
            lse.reshape(B * H, Sq), delta.reshape(B * H, Sq), scale, causal)
        return _to_bshd(dq, B, H)
    (q, k, v, do), meta = _prepare("flash_bwd_dq", q, k, v, do)
    _check_rows("lse", lse, B, H, Sq, q)
    _check_rows("delta", delta, B, H, Sq, q)
    dq = torch.empty(B, Sq, H, D, dtype=q.dtype, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), meta,
            float(scale), int(bool(causal)))
    rc = _kernel(_entry("bwd_dq", q))(*args, _DTYPES[q.dtype], _stream())
    _raise_if(rc, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal):
    """-> ``(dK, dV)``, contiguous [B, Sk, H, D] in k's type. Every kernel
    launch adds one to ``flash_bwd_dkv.launches``."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if not _on_cuda("flash_bwd_dkv", q):
        dk, dv = flash_bwd_dkv_reference(
            _to_bhsd(q), _to_bhsd(k), _to_bhsd(v), _to_bhsd(do),
            lse.reshape(B * H, Sq), delta.reshape(B * H, Sq), scale, causal)
        return _to_bshd(dk, B, H), _to_bshd(dv, B, H)
    (q, k, v, do), meta = _prepare("flash_bwd_dkv", q, k, v, do)
    _check_rows("lse", lse, B, H, Sq, q)
    _check_rows("delta", delta, B, H, Sq, q)
    dk = torch.empty(B, Sk, H, D, dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            meta, float(scale), int(bool(causal)))
    rc = _kernel(_entry("bwd_dkv", q))(*args, _DTYPES[q.dtype], _stream())
    _raise_if(rc, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The ``custom_vjp`` of ``flash_attention.py:314-334``: the forward
    saves ``(q, k, v, O, lse)``; the backward computes delta and runs the
    dQ and dK/dV kernels."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        o, lse = flash_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = flash_delta(o, do)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.scale, ctx.causal)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.scale,
                               ctx.causal)
        return dq, dk, dv, None, None

