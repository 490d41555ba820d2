"""Hand-written Hopper kernels of the port, each beside its plain version.

===========================  =======  =========================================
wrapper                      route    replaces (TPU kernel)
===========================  =======  =========================================
``ragged_paged_attention``   CUDA C++ ``ops/pallas/ragged_attention.py:108``
``layer_norm``               Triton   ``ops/pallas/layer_norm.py:39``
``flash_fwd``                CUDA C++ ``ops/pallas/flash_attention.py:106``
``flash_bwd_dq``             CUDA C++ ``ops/pallas/flash_attention.py:262``
``flash_bwd_dkv``            CUDA C++ ``ops/pallas/flash_attention.py:285``
``fused_adamw``              CUDA C++ ``ops/pallas/fused_adamw.py:60``
``paged_attention``          CUDA C++ ``ops/pallas/paged_attention.py:175``
``rms_norm``                 Triton   ``ops/pallas/rms_norm.py:39``
===========================  =======  =========================================

``paged_attention`` (one decode token a row, split-K over the row's own
keys) and ``ragged_paged_attention`` (tiles of a row's tokens) are kernels
and launches of their own; each sizes its launch on the host
(``launch_plan``) and takes its split scratch from the caller
(``scratch=``, which a captured graph needs) or a per-device cache.
``flash_fwd`` and ``flash_bwd_dkv`` launch the Hopper kernels of
``csrc/flash_attention_sm90.cu`` (wgmma, TMA, warp specialisation; its
primitives in ``csrc/sm90.cuh``) on bf16 and ``csrc/flash_attention.cu``
on f32, where ``flash_bwd_dq`` runs for both.

Each wrapper counts its kernel launches in a plain integer attribute
(``wrapper.launches``), so a run can show that its main path went through
the kernel; :func:`launch_counts` / :func:`reset_launch_counts` read and
zero them all. A CUDA graph replays kernels without running their
wrappers, so whoever replays one adds the launches its capture recorded
(:func:`add_launch_counts`): the counts stay the launches issued on the
card.
"""
from .flash_attention import (flash_attention_bshd, flash_bwd_dkv,
                              flash_bwd_dkv_reference, flash_bwd_dq,
                              flash_bwd_dq_reference, flash_delta, flash_fwd,
                              flash_fwd_reference)
from .fused_adamw import fused_adamw, fused_adamw_reference
from .layer_norm import (LayerNormFunction, layer_norm,
                         layer_norm_bwd_reference, layer_norm_reference)
from .paged_attention import (paged_attention, paged_attention_reference,
                              paged_prefill_reference)
from .ragged_attention import (ragged_paged_attention,
                               ragged_paged_attention_reference,
                               ragged_row_index)
from .rms_norm import (RMSNormFunction, rms_norm, rms_norm_bwd_reference,
                       rms_norm_reference)

__all__ = ["layer_norm", "layer_norm_reference", "layer_norm_bwd_reference",
           "LayerNormFunction", "ragged_paged_attention",
           "ragged_paged_attention_reference", "paged_attention_reference",
           "ragged_row_index", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
           "flash_fwd_reference", "flash_bwd_dq_reference",
           "flash_bwd_dkv_reference", "flash_delta", "flash_attention_bshd",
           "fused_adamw", "fused_adamw_reference", "paged_attention",
           "paged_prefill_reference", "rms_norm", "rms_norm_reference",
           "rms_norm_bwd_reference", "RMSNormFunction", "KERNELS",
           "launch_counts", "reset_launch_counts", "add_launch_counts"]

KERNELS = {"ragged_paged_attention": ragged_paged_attention,
           "layer_norm": layer_norm,
           "flash_fwd": flash_fwd,
           "flash_bwd_dq": flash_bwd_dq,
           "flash_bwd_dkv": flash_bwd_dkv,
           "fused_adamw": fused_adamw,
           "paged_attention": paged_attention,
           "rms_norm": rms_norm}


def launch_counts():
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def add_launch_counts(counts):
    """Add ``{name: launches}`` to the wrappers' counts (a graph replay's
    launches, or minus a capture's, which launched nothing)."""
    for name, n in counts.items():
        KERNELS[name].launches += n
