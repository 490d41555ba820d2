"""The kernels as ``torch.library`` ops, so a traced program holds them.

The hand kernels are ``ctypes`` and Triton calls, which neither
``torch.export`` nor a static program's recorder can see into: traced as
they are, a program would hold the plain f32 chains of the CPU, or fail
on the card. Each kernel that an inference program runs is therefore
also one op of the ``paddle_tpu_torch`` namespace:

=====================================  ===========================  ======
op                                     CUDA (the kernel)            CPU
=====================================  ===========================  ======
``paddle_tpu_torch::flash_fwd``        kernel 1, -> ``(O, lse)``    plain
``paddle_tpu_torch::layer_norm``       kernel 8                     plain
``paddle_tpu_torch::rms_norm``         kernel 7                     plain
=====================================  ===========================  ======

The CUDA implementation of each op is the kernel's wrapper, which launches
the kernel and counts the launch (``launch_counts()``); the CPU
implementation is the kernel's plain version. Each op has a fake (shape)
implementation, and an autograd formula, the backward of its
``autograd.Function`` (the dQ and dK/dV kernels for ``flash_fwd``), so a
static program that records one can still be minimized. Registering
builds nothing: the kernels build at their first launch, as always.

This module is the one place that chooses between the op and the
``autograd.Function``: every caller goes through
:func:`flash_attention_bshd`, :func:`layer_norm_fn` or
:func:`rms_norm_fn`. Eager calls keep their ``autograd.Function`` paths
unchanged (the eager launch counts and bit-equality do not move). Only a
traced call becomes an op: :func:`recording` is true while
``torch.export`` traces, and for the symbolic variables of a static
program (``static/program.py``). The configurations the flash kernels
take then no longer depend on the tracing device, so a program exported
on the CPU launches the kernels when it runs on the card.
"""
import math
from typing import Optional

import torch

from . import flash_attention as _fa
from .layer_norm import LayerNormFunction
from .layer_norm import layer_norm as _layer_norm
from .layer_norm import layer_norm_bwd_reference, layer_norm_reference
from .rms_norm import RMSNormFunction
from .rms_norm import rms_norm as _rms_norm
from .rms_norm import rms_norm_bwd_reference, rms_norm_reference

__all__ = ["recording", "flash_attention_bshd", "layer_norm_fn",
           "rms_norm_fn", "OPS"]

Tensor = torch.Tensor


def recording(x):
    """True while ``x`` flows into a traced program: an export is tracing,
    or ``x`` is a static program's symbolic variable."""
    return torch.compiler.is_exporting() or getattr(x, "_pd_recording",
                                                    False)


# ------------------------------------------------------------ flash_fwd
@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=(),
                         device_types="cuda")
def flash_fwd(q: Tensor, k: Tensor, v: Tensor, scale: float,
              causal: bool) -> tuple[Tensor, Tensor]:
    """Kernel 1 on ``[B, S, H, D]`` -> ``(O, lse)``."""
    return _fa.flash_fwd(q, k, v, scale, causal)


@flash_fwd.register_kernel("cpu")
def _flash_fwd_cpu(q, k, v, scale, causal):
    B, Sq, H, _ = q.shape
    o, lse = _fa.flash_fwd_reference(_fa._to_bhsd(q), _fa._to_bhsd(k),
                                     _fa._to_bhsd(v), scale, causal)
    return _fa._to_bshd(o, B, H), lse.reshape(B, H, Sq)


@flash_fwd.register_fake
def _flash_fwd_fake(q, k, v, scale, causal):
    B, Sq, H, D = q.shape
    return (q.new_empty((B, Sq, H, D)),
            q.new_empty((B, H, Sq), dtype=torch.float32))


def _flash_setup(ctx, inputs, output):
    q, k, v, scale, causal = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.scale, ctx.causal = scale, causal


def _flash_backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    do = do.contiguous()
    delta = _fa.flash_delta(o, do)
    dq = _fa.flash_bwd_dq(q, k, v, do, lse, delta, ctx.scale, ctx.causal)
    dk, dv = _fa.flash_bwd_dkv(q, k, v, do, lse, delta, ctx.scale,
                               ctx.causal)
    return dq, dk, dv, None, None


flash_fwd.register_autograd(_flash_backward, setup_context=_flash_setup)


# ------------------------------------------------------------ the norms
def _norm_op(name, wrapper, reference, bwd):
    """The op ``paddle_tpu_torch::<name>(x, weight, bias, eps)`` over the
    kernel's ``wrapper`` (CUDA) and ``reference`` (CPU), differentiable
    by ``bwd``."""
    @torch.library.custom_op(f"paddle_tpu_torch::{name}", mutates_args=(),
                             device_types="cuda")
    def op(x: Tensor, weight: Optional[Tensor], bias: Optional[Tensor],
           eps: float) -> Tensor:
        return wrapper(x, weight, bias, eps)

    @op.register_kernel("cpu")
    def _cpu(x, weight, bias, eps):
        return reference(x, weight, bias, eps)

    @op.register_fake
    def _fake(x, weight, bias, eps):
        return x.new_empty(x.shape)

    def setup(ctx, inputs, output):
        x, weight, bias, eps = inputs
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        ctx.bias_dtype = None if bias is None else bias.dtype

    def backward(ctx, ct):
        x, weight = ctx.saved_tensors
        dx, dw, db = bwd(x, weight, ct, ctx.eps)
        return (dx, None if weight is None else dw.to(weight.dtype),
                None if ctx.bias_dtype is None else db.to(ctx.bias_dtype),
                None)

    op.register_autograd(backward, setup_context=setup)
    return op


layer_norm_op = _norm_op("layer_norm", _layer_norm, layer_norm_reference,
                         layer_norm_bwd_reference)
rms_norm_op = _norm_op("rms_norm", _rms_norm, rms_norm_reference,
                       rms_norm_bwd_reference)

OPS = {"flash_fwd": torch.ops.paddle_tpu_torch.flash_fwd.default,
       "layer_norm": torch.ops.paddle_tpu_torch.layer_norm.default,
       "rms_norm": torch.ops.paddle_tpu_torch.rms_norm.default}


# ------------------------------------------------------- the entries
def flash_attention_bshd(q, k, v, causal=True, scale=None):
    """Flash attention on ``[B, S, H, D]`` tensors (paddle's layout) ->
    ``[B, Sq, H, D]``, differentiable in q, k and v; ``scale`` defaults to
    ``1/sqrt(D)``. Eager, the kernels' ``autograd.Function``
    (``flash_attention.py``); traced, the ``flash_fwd`` op."""
    scale = float(scale if scale is not None else 1.0 / math.sqrt(
        q.shape[-1]))
    if recording(q):
        return torch.ops.paddle_tpu_torch.flash_fwd(q, k, v, scale,
                                                    bool(causal))[0]
    return _fa._FlashAttention.apply(q, k, v, scale, bool(causal))


def layer_norm_fn(x, weight, bias, eps):
    """Differentiable LayerNorm of ``x``'s rows: :class:`LayerNormFunction`
    eager, the ``layer_norm`` op traced."""
    if recording(x):
        return torch.ops.paddle_tpu_torch.layer_norm(x, weight, bias,
                                                     float(eps))
    return LayerNormFunction.apply(x, weight, bias, float(eps))


def rms_norm_fn(x, weight, bias, eps):
    """Differentiable RMSNorm of ``x``'s rows: :class:`RMSNormFunction`
    eager, the ``rms_norm`` op traced."""
    if recording(x):
        return torch.ops.paddle_tpu_torch.rms_norm(x, weight, bias,
                                                   float(eps))
    return RMSNormFunction.apply(x, weight, bias, float(eps))
