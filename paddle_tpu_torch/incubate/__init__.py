"""incubate — the fused entry points of ``paddle_tpu/incubate/__init__.py``:
``fused_rms_norm`` (the ``rms_norm`` Triton kernel), ``paged_attention``
(the paged decode CUDA kernel), ``flash_attention`` (the flash kernels,
through ``nn.functional.scaled_dot_product_attention``),
``fused_layer_norm`` (the ``layer_norm`` Triton kernel),
``fused_rotary_position_embedding``, the fused softmaxes and
``identity_loss``; the ``nn`` and ``autograd`` subpackages.

The JAX package chooses between its Pallas kernel and a jnp composition
with ``use_pallas``/``interpret`` and a measured gate; the port has no
Pallas and no gate, so both arguments are gone: a CUDA tensor runs the
hand-written kernel, a CPU tensor its plain version. The graph and
segment ops, ``MoELayer`` / ``TopKGate``, ``LookAhead`` /
``ModelAverage``, ``ring_attention`` and ``asp`` are not ported yet.
"""
from __future__ import annotations


import torch

from ..nn import functional as F
from ..ops.kernels import paged_attention_reference
from ..ops.kernels.library import rms_norm_fn
from ..ops.kernels import paged_attention as _paged_attention_kernel
from . import autograd, nn  # noqa: F401

__all__ = ["fused_rms_norm", "fused_layer_norm",
           "fused_rotary_position_embedding", "flash_attention",
           "paged_attention", "softmax_mask_fuse",
           "softmax_mask_fuse_upper_triangle", "identity_loss", "nn",
           "autograd"]


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1):
    """RMSNorm over the last axis of ``x`` with ``norm_weight`` and an
    optional ``norm_bias`` (``incubate/__init__.py:60``), differentiable in
    all three. Every call normalises the last axis whatever
    ``begin_norm_axis`` is, as both arms of the JAX function do. The bias
    is added in f32 inside the kernel (the JAX kernel's arm); the JAX jnp
    arm adds it after casting to x's type, which differs from this by at
    most one rounding in bf16."""
    return rms_norm_fn(x, norm_weight, norm_bias, epsilon)


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


def fused_layer_norm(x, norm_weight, norm_bias, epsilon=1e-5,
                     begin_norm_axis=-1):
    """LayerNorm over the axes from ``begin_norm_axis`` on
    (``incubate/__init__.py:101``), with ``norm_weight`` / ``norm_bias``
    of their shape (or of their product) or None. Both arms run the
    ``layer_norm`` kernel through ``nn.functional.layer_norm``: the last
    axis as JAX's Pallas arm does, several trailing axes viewed as one
    row of their product (the JAX package takes jnp there)."""
    ax = begin_norm_axis % x.dim()
    return F.layer_norm(x, list(x.shape[ax:]), norm_weight, norm_bias,
                        epsilon)


def _rope_tables(s, d, device):
    """The default neox tables [1, s, 1, d] in f32 (``:158-166``: inverse
    frequencies 10000^(-2i/d), the angles repeated over both halves),
    made on ``device``."""
    inv = 1.0 / (10000 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=device) / d))
    t = torch.arange(s, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    emb = torch.cat([freqs, freqs], dim=-1)[None, :, None, :]
    return emb.sin(), emb.cos()


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None, use_neox_rotary_style
                                    =True):
    """Rotary position embedding of ``q``, ``k`` and ``v`` [B, S, H, D]
    (``incubate/__init__.py:145``), with JAX's choices: the neox rotation
    (halves) whatever ``use_neox_rotary_style`` says, ``position_ids``
    ignored, and always a 3-tuple (None where an input is None).
    ``sin`` / ``cos`` broadcast against the inputs; without them the
    default tables of positions 0..S-1 are made on the inputs' device, in
    f32 (so a 16-bit input comes back in f32, as JAX promotes it)."""
    if sin is None or cos is None:
        sin, cos = _rope_tables(q.shape[1], q.shape[-1], q.device)

    def rope_one(a):
        half = a.shape[-1] // 2
        rot = torch.cat([-a[..., half:], a[..., :half]], dim=-1)
        return a * cos + rot * sin

    return tuple(None if a is None else rope_one(a) for a in (q, k, v))


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, name=None):
    """``(out, None)``: attention on [B, S, H, D] through
    ``nn.functional.scaled_dot_product_attention`` (the flash kernels on
    an eligible CUDA tensor). ``return_softmax=True`` raises: the kernels
    never form the softmax."""
    if return_softmax:
        raise NotImplementedError(
            "return_softmax=True is not supported: the flash kernel never "
            "materializes the softmax matrix (that is the point)")
    out = F.scaled_dot_product_attention(query, key, value, dropout_p=dropout,
                                         is_causal=causal)
    return out, None


def softmax_mask_fuse(x, mask, name=None):
    """``softmax(x + mask)`` over the last axis."""
    return torch.softmax(x + mask, dim=-1)


def softmax_mask_fuse_upper_triangle(x):
    """The causal softmax of [..., S, S] scores: the upper triangle filled
    with -1e4 (as JAX fills it), then softmax over the last axis."""
    s = x.shape[-1]
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    return torch.softmax(x.masked_fill(~causal, -1e4), dim=-1)


def identity_loss(x, reduction="none"):
    """``x`` reduced by ``reduction`` (``"sum"`` / 0, ``"mean"`` / 1,
    ``"none"`` / 2)."""
    red = {0: "sum", 1: "mean", 2: "none"}.get(reduction, reduction)
    if red == "mean":
        return x.mean()
    if red == "sum":
        return x.sum()
    return x
