"""incubate — the fused entry points of ``paddle_tpu/incubate/__init__.py``
whose kernels the port has: ``fused_rms_norm`` (the ``rms_norm`` Triton
kernel) and ``paged_attention`` (the paged decode CUDA kernel).

The JAX package chooses between its Pallas kernel and a jnp composition
with ``use_pallas``/``interpret`` and a measured gate; the port has no
Pallas and no gate, so both arguments are gone: a CUDA tensor runs the
hand-written kernel, a CPU tensor its plain version.
"""
from __future__ import annotations

import torch

from ..ops.kernels import RMSNormFunction, paged_attention_reference
from ..ops.kernels import paged_attention as _paged_attention_kernel
from . import nn  # noqa: F401

__all__ = ["fused_rms_norm", "paged_attention", "nn"]


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1):
    """RMSNorm over the last axis of ``x`` with ``norm_weight`` and an
    optional ``norm_bias`` (``incubate/__init__.py:60``), differentiable in
    all three. Every call normalises the last axis whatever
    ``begin_norm_axis`` is, as both arms of the JAX function do. The bias
    is added in f32 inside the kernel (the JAX kernel's arm); the JAX jnp
    arm adds it after casting to x's type, which differs from this by at
    most one rounding in bf16."""
    return RMSNormFunction.apply(x, norm_weight, norm_bias, float(epsilon))


class _PagedAttention(torch.autograd.Function):
    """The counterpart of ``paged_attention_trainable``
    (``ops/pallas/paged_attention.py:220-244``): the kernel forward, the
    backward by autograd through the plain gather formulation."""

    @staticmethod
    def forward(ctx, q, k_cache, v_cache, block_tables, context_lens, scale):
        ctx.save_for_backward(q, k_cache, v_cache, block_tables,
                              context_lens)
        ctx.scale = scale
        return _paged_attention_kernel(q, k_cache, v_cache, block_tables,
                                       context_lens, scale=scale)

    @staticmethod
    def backward(ctx, ct):
        q, kc, vc, bt, cl = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in (q, kc, vc)]
            out = paged_attention_reference(*ins, bt, cl, scale=ctx.scale)
            grads = torch.autograd.grad(out, ins, ct)
        return (*grads, None, None, None)


def paged_attention(q, k_cache, v_cache, block_tables, context_lens,
                    scale=None):
    """Decode attention over a paged KV cache (``incubate/__init__.py:25``):
    ``q`` [B, H, D], pools [P, page, KVH, D], ``block_tables`` [B,
    max_pages] int32, ``context_lens`` [B] int32 -> [B, H, D].
    Differentiable in q and both pools."""
    return _PagedAttention.apply(q, k_cache, v_cache, block_tables,
                                 context_lens, scale)
