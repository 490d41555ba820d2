"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package ``paddle_tpu`` stays the reference; this package mirrors
its layout (``models/gpt.py``, ``serving/engine.py``, ...) with PyTorch
inside. Every Pallas kernel on a ported path is a kernel written by hand
for ``sm_90a`` under ``ops/kernels/`` (CUDA C++ in ``csrc/``, or Triton),
each beside a plain PyTorch version that the CPU runs and the tests use.

It serves a GPT through the continuous-batching ragged paged-KV engine::

    import paddle_tpu_torch as pt
    model = pt.GPTForCausalLM(pt.gpt_1p3b(dropout=0.0),
                              dtype=torch.bfloat16)      # on cuda
    eng = pt.ServingEngine(model, page_size=16, num_pages=2048,
                           max_slots=16, prefill_chunk=256)
    tokens = eng.generate(prompt_ids, max_new_tokens=32)

and trains one (flash attention forward and backward, fused AdamW)::

    cfg = pt.gpt_1p3b(dropout=0.0)
    model = pt.GPTForCausalLM(cfg)                       # f32, on cuda
    crit = pt.GPTPretrainingCriterion(cfg)
    opt = pt.AdamW(learning_rate=1e-4, parameters=model.parameters())
    model.train()
    with pt.auto_cast(level="O1", dtype="bfloat16"):
        loss = crit(model(ids), labels)
    loss.backward(); opt.step(); opt.clear_grad()

Entry points run on ``cuda`` unless given ``device="cpu"`` and raise when
CUDA is absent (:mod:`.device`). The package imports neither ``jax`` nor
``paddle_tpu``.
"""
from .amp import auto_cast
from .convert import params_from_paddle_tpu, params_to_numpy
from .device import resolve_device
from .models.gpt import (GPTConfig, GPTForCausalLM, GPTPretrainingCriterion,
                         gpt_13b, gpt_1p3b, gpt_small, gpt_tiny)
from .ops.kernels import flash_attention_bshd
from .optimizer import Adam, AdamW
from .serving.engine import ServingEngine

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTPretrainingCriterion",
           "ServingEngine", "Adam", "AdamW", "auto_cast",
           "flash_attention_bshd", "params_from_paddle_tpu",
           "params_to_numpy", "resolve_device", "gpt_tiny", "gpt_small",
           "gpt_1p3b", "gpt_13b"]
