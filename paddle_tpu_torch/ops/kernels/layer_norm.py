"""Row LayerNorm forward — a Triton kernel and its plain PyTorch version.

Replaces: ``paddle_tpu/ops/pallas/layer_norm.py:39`` (``_fwd_pallas``, body
``_kernel`` at :25): per row, mean and biased variance in f32,
``(x - mean) * rsqrt(var + eps)``, optional weight and bias, output in x's
type. The JAX GPT computes the same function in XLA
(``nn/functional/norm.py:18``); the port's GPT LayerNorms run this kernel.

Bound: bytes. One read of each row and one write, a handful of flops per
element. The kernel is one program per row with ``BLOCK =
next_power_of_2(H)`` lanes, masked: the row is loaded once into registers,
reduced twice (mean, then the centred variance) and written once, so it
moves the least bytes the function allows. A later PR may take several
rows per program for small H.

``triton`` is imported inside the launching function: the CPU, where the
tests run, has no Triton, and a CPU tensor takes the plain version.
"""
from __future__ import annotations

import torch

__all__ = ["layer_norm_reference", "layer_norm"]

_kernel_fn = None


def layer_norm_reference(x, weight=None, bias=None, eps=1e-5):
    """The plain version over the last axis: f32 statistics, output in
    x's type."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    out = xc * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def _triton_kernel():
    global _kernel_fn, triton, tl
    if _kernel_fn is None:
        import triton
        import triton.language as tl

        @triton.jit
        def layer_norm_fwd(x_ptr, w_ptr, b_ptr, y_ptr, stride_x, stride_y,
                           n_cols, eps, HAS_W: tl.constexpr,
                           HAS_B: tl.constexpr, BLOCK: tl.constexpr):
            row = tl.program_id(0)
            cols = tl.arange(0, BLOCK)
            mask = cols < n_cols
            x = tl.load(x_ptr + row * stride_x + cols, mask=mask,
                        other=0.0).to(tl.float32)
            mean = tl.sum(x, axis=0) / n_cols
            xc = tl.where(mask, x - mean, 0.0)
            var = tl.sum(xc * xc, axis=0) / n_cols
            y = xc * (1.0 / tl.sqrt(var + eps))
            if HAS_W:
                y = y * tl.load(w_ptr + cols, mask=mask,
                                other=0.0).to(tl.float32)
            if HAS_B:
                y = y + tl.load(b_ptr + cols, mask=mask,
                                other=0.0).to(tl.float32)
            tl.store(y_ptr + row * stride_y + cols,
                     y.to(y_ptr.dtype.element_ty), mask=mask)

        _kernel_fn = (layer_norm_fwd, triton.next_power_of_2)
    return _kernel_fn


def layer_norm(x, weight=None, bias=None, eps=1e-5):
    """LayerNorm over the last axis of ``x`` [..., H]. CPU tensors take
    the plain version; CUDA tensors (f32, bf16 or f16) launch the Triton
    kernel and every launch adds one to ``layer_norm.launches``; anything
    else raises."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm runs on cuda (kernel) or cpu (plain "
                         f"version), not {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"layer_norm takes float32/bfloat16/float16, got "
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
        layer_norm.launches += 1
    return y.reshape(x.shape)


layer_norm.launches = 0
