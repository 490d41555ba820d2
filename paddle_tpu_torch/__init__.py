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

decodes by itself as the JAX model does (greedy over a static KV cache,
one CUDA graph a step; eager over the dense cache; sampled)::

    out = model.generate(ids, max_new_tokens=256, temperature=0.0)

and pretrains one (flash attention forward and backward, fused AdamW
with f32 master weights) in O2 bf16, with a warm-up and cosine schedule,
a global-norm clip and, optionally, per-block recompute::

    cfg = pt.gpt_1p3b(dropout=0.0)                       # recompute=True
    model = pt.GPTForCausalLM(cfg)                       # f32, on cuda
    crit = pt.GPTPretrainingCriterion(cfg)
    sched = pt.optimizer.lr.LinearWarmup(
        pt.optimizer.lr.CosineAnnealingDecay(1e-4, T_max=100), 4, 0.0, 1e-4)
    opt = pt.AdamW(learning_rate=sched, parameters=model.parameters(),
                   multi_precision=True,
                   grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
    model, opt = pt.amp.decorate(model, opt, level="O2", dtype="bfloat16")
    model.train()
    with pt.auto_cast(level="O2", dtype="bfloat16"):
        loss = crit(model(ids), labels)
    loss.backward(); opt.step(); opt.clear_grad(); sched.step()

``opt.state_dict()`` and ``opt.set_state_dict(...)`` save and resume the
moments, masters and schedule; ``pt.amp.GradScaler`` scales the loss;
O1 (f32 weights, ``auto_cast(level="O1")``) trains without ``decorate``.

Entry points run on ``cuda`` unless given ``device="cpu"`` and raise when
CUDA is absent (:mod:`.device`). The package imports neither ``jax`` nor
``paddle_tpu``.
"""
from . import amp, distributed, nn, optimizer, regularizer
from .amp import auto_cast
from .convert import (opt_state_from_paddle_tpu, opt_state_to_numpy,
                      params_from_paddle_tpu, params_to_numpy)
from .device import resolve_device
from .models.gpt import (GPTConfig, GPTForCausalLM, GPTPretrainingCriterion,
                         gpt_13b, gpt_1p3b, gpt_small, gpt_tiny)
from .ops.kernels import flash_attention_bshd
from .optimizer import Adam, AdamW
from .serving.engine import ServingEngine

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTPretrainingCriterion",
           "ServingEngine", "Adam", "AdamW", "auto_cast",
           "flash_attention_bshd", "params_from_paddle_tpu",
           "params_to_numpy", "opt_state_from_paddle_tpu",
           "opt_state_to_numpy", "resolve_device", "amp", "distributed",
           "nn", "optimizer", "regularizer", "gpt_tiny", "gpt_small",
           "gpt_1p3b", "gpt_13b"]
