"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package ``paddle_tpu`` stays the reference; this package mirrors
its layout (``models/gpt.py``, ``serving/engine.py``, ...) with PyTorch
inside. Every Pallas kernel on a ported path is a kernel written by hand
for ``sm_90a`` under ``ops/kernels/`` (CUDA C++ in ``csrc/``, or Triton),
each beside a plain PyTorch version that the CPU runs and the tests use.

This slice serves a GPT through the continuous-batching ragged paged-KV
engine::

    import paddle_tpu_torch as pt
    model = pt.GPTForCausalLM(pt.gpt_1p3b(dropout=0.0),
                              dtype=torch.bfloat16)      # on cuda
    eng = pt.ServingEngine(model, page_size=16, num_pages=2048,
                           max_slots=16, prefill_chunk=256)
    tokens = eng.generate(prompt_ids, max_new_tokens=32)

Entry points run on ``cuda`` unless given ``device="cpu"`` and raise when
CUDA is absent (:mod:`.device`). The package imports neither ``jax`` nor
``paddle_tpu``.
"""
from .convert import params_from_paddle_tpu
from .device import resolve_device
from .models.gpt import (GPTConfig, GPTForCausalLM, gpt_13b, gpt_1p3b,
                         gpt_small, gpt_tiny)
from .serving.engine import ServingEngine

__all__ = ["GPTConfig", "GPTForCausalLM", "ServingEngine",
           "params_from_paddle_tpu", "resolve_device", "gpt_tiny",
           "gpt_small", "gpt_1p3b", "gpt_13b"]
