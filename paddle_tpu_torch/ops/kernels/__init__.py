"""Hand-written Hopper kernels of the port, each beside its plain version.

===========================  =======  =====================================
wrapper                      route    replaces (TPU kernel)
===========================  =======  =====================================
``ragged_paged_attention``   CUDA C++ ``ops/pallas/ragged_attention.py:108``
``layer_norm``               Triton   ``ops/pallas/layer_norm.py:39``
===========================  =======  =====================================

Each wrapper counts its kernel launches in a plain integer attribute
(``wrapper.launches``), so a run can show that its main path went through
the kernel; :func:`launch_counts` / :func:`reset_launch_counts` read and
zero them all.
"""
from .layer_norm import layer_norm, layer_norm_reference
from .ragged_attention import (paged_attention_reference,
                               ragged_paged_attention,
                               ragged_paged_attention_reference,
                               ragged_row_index)

__all__ = ["layer_norm", "layer_norm_reference", "ragged_paged_attention",
           "ragged_paged_attention_reference", "paged_attention_reference",
           "ragged_row_index", "KERNELS", "launch_counts",
           "reset_launch_counts"]

KERNELS = {"ragged_paged_attention": ragged_paged_attention,
           "layer_norm": layer_norm}


def launch_counts():
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0
