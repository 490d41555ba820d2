"""Row RMSNorm — a Triton forward kernel, its plain PyTorch version and
the differentiable layer over both.

Replaces: ``paddle_tpu/ops/pallas/rms_norm.py:39`` (``_fwd_pallas``,
bodies ``_kernel`` at :22 and ``_kernel_bias`` at :30): per row, the mean
square in f32, ``x * rsqrt(mean(x^2) + eps) * w``, plus ``b`` in the bias
variant (added in f32), output in x's type. The JAX GPT with
``use_rms_norm=True`` computes the same function in XLA
(``nn/functional/norm.py:42``); the port's RMSNorm runs this kernel.

Bound: bytes. One read of each row and one write, a handful of flops per
element. The kernel is one program per row with ``BLOCK =
next_power_of_2(H)`` lanes, masked: the row is loaded once into registers,
reduced once and written once, so it moves the least bytes the function
allows. Pallas pads the rows up to its 256-row tile
(``_common.pad_rows_to_grid``); a program per row needs no padding and
masks only the lanes past H. It is the twin of ``layer_norm.py``'s kernel.

``triton`` is imported inside the launching function: the CPU, where the
tests run, has no Triton, and a CPU tensor takes the plain version.

:class:`RMSNormFunction` makes it differentiable, as the JAX kernel's
``custom_vjp`` does (``ops/pallas/rms_norm.py:82-122``): the forward is
the wrapper (the kernel on the card), the backward is
:func:`rms_norm_bwd_reference`, the plain port of ``_bwd_math`` (:68-79)
with the bias gradient of ``_rms_b_bwd`` — the JAX backward is jnp, not a
Pallas kernel.
"""
from __future__ import annotations

import torch

__all__ = ["rms_norm_reference", "rms_norm", "rms_norm_bwd_reference",
           "RMSNormFunction"]

_kernel_fn = None


def rms_norm_reference(x, weight=None, bias=None, eps=1e-6):
    """The plain version over the last axis: f32 statistics, the bias
    added in f32, output in x's type."""
    xf = x.float()
    out = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def _triton_kernel():
    global _kernel_fn
    if _kernel_fn is None:
        import triton
        import triton.language as tl

        @triton.jit
        def rms_norm_fwd(x_ptr, w_ptr, b_ptr, y_ptr, stride_x, stride_y,
                         n_cols, eps, HAS_W: tl.constexpr,
                         HAS_B: tl.constexpr, BLOCK: tl.constexpr):
            row = tl.program_id(0).to(tl.int64)
            cols = tl.arange(0, BLOCK)
            mask = cols < n_cols
            x = tl.load(x_ptr + row * stride_x + cols, mask=mask,
                        other=0.0).to(tl.float32)
            ms = tl.sum(x * x, axis=0) / n_cols
            y = x * (1.0 / tl.sqrt(ms + eps))
            if HAS_W:
                y = y * tl.load(w_ptr + cols, mask=mask,
                                other=0.0).to(tl.float32)
            if HAS_B:
                y = y + tl.load(b_ptr + cols, mask=mask,
                                other=0.0).to(tl.float32)
            tl.store(y_ptr + row * stride_y + cols,
                     y.to(y_ptr.dtype.element_ty), mask=mask)

        _kernel_fn = (rms_norm_fwd, triton.next_power_of_2)
    return _kernel_fn


def rms_norm(x, weight=None, bias=None, eps=1e-6):
    """RMSNorm over the last axis of ``x`` [..., H]. CPU tensors take the
    plain version; CUDA tensors (f32, bf16 or f16) launch the Triton kernel
    and every launch adds one to ``rms_norm.launches``; anything else
    raises."""
    if x.device.type == "cpu":
        return rms_norm_reference(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm runs on cuda (kernel) or cpu (plain "
                         f"version), not {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"rms_norm takes float32/bfloat16/float16, got "
                        f"{x.dtype}")
    H = x.shape[-1]
    for name, p in (("weight", weight), ("bias", bias)):
        if p is not None and (p.shape != (H,) or p.device != x.device
                              or not p.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous [{H}] tensor on "
                             f"{x.device}")
    x2 = x.reshape(-1, H)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    y = torch.empty_like(x2)
    R = x2.shape[0]
    if R:
        kern, next_pow2 = _triton_kernel()
        block = next_pow2(H)
        kern[(R,)](x2, weight if weight is not None else x2,
                   bias if bias is not None else x2, y, x2.stride(0),
                   y.stride(0), H, float(eps), HAS_W=weight is not None,
                   HAS_B=bias is not None, BLOCK=block,
                   num_warps=min(max(block // 256, 1), 8))
        rms_norm.launches += 1
    return y.reshape(x.shape)


rms_norm.launches = 0


def rms_norm_bwd_reference(x, weight, ct, eps=1e-6):
    """The RMSNorm gradient over the last axis (``_bwd_math`` and
    ``_rms_b_bwd``): ``x`` the forward input, ``ct`` the output's cotangent
    -> ``(dx, dw, db)``, with dx in x's type and dw, db f32 sums over every
    leading axis (the caller casts them to the parameters' types)."""
    xf, ctf = x.float(), ct.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    xhat = xf * inv
    ctw = ctf * weight.float() if weight is not None else ctf
    dx = inv * (ctw - xhat * (ctw * xhat).mean(dim=-1, keepdim=True))
    axes = tuple(range(x.dim() - 1))
    return dx.to(x.dtype), (ctf * xhat).sum(dim=axes), ctf.sum(dim=axes)


class RMSNormFunction(torch.autograd.Function):
    """``RMSNormFunction.apply(x, weight, bias, eps)``: the forward is
    :func:`rms_norm` (the Triton kernel on a CUDA tensor), the backward
    :func:`rms_norm_bwd_reference`."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        ctx.bias_dtype = None if bias is None else bias.dtype
        return rms_norm(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, ct):
        x, weight = ctx.saved_tensors
        dx, dw, db = rms_norm_bwd_reference(x, weight, ct, ctx.eps)
        return (dx, None if weight is None else dw.to(weight.dtype),
                None if ctx.bias_dtype is None else db.to(ctx.bias_dtype),
                None)
