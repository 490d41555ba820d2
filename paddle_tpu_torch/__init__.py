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

The JAX package's other models train the same way, over the layers of
``pt.nn`` (Conv2D, BatchNorm2D, the pools, the Transformer layers) and
``pt.SGD`` / ``pt.Momentum``: ``pt.LeNet``, the ResNets (``pt.resnet50``,
O2 in float16 with a ``GradScaler``), BERT (``pt.BertForMaskedLM(
pt.bert_base())``, its encoder on the flash kernels at head dim 64) and
``pt.Seq2SeqTransformer``::

    model = pt.resnet50(num_classes=1000)                # f32, on cuda
    opt = pt.Momentum(0.1, 0.9, parameters=model.parameters(),
                      weight_decay=pt.regularizer.L2Decay(1e-4),
                      multi_precision=True)
    model, opt = pt.amp.decorate(model, opt, level="O2", dtype="float16")
    scaler = pt.amp.GradScaler(init_loss_scaling=2.0 ** 15)
    with pt.auto_cast(level="O2", dtype="float16"):
        loss = pt.nn.functional.cross_entropy(model(images), labels)
    scaler.scale(loss).backward(); scaler.step(opt); scaler.update()
    opt.clear_grad()

``pt.jit.to_static`` stages a whole training step as one CUDA graph
that replays the hand kernels (the JAX package's ``jit.to_static``,
one XLA program a step); the LR scheduler steps outside it::

    def train_step(ids, labels):
        with pt.auto_cast(level="O2", dtype="bfloat16"):
            loss = crit(model(ids), labels)
        loss.backward(); opt.step(); opt.clear_grad()
        return loss
    step = pt.jit.to_static(train_step, capture=(model, opt))
    loss = step(ids, labels); sched.step()

The vision zoo of ``paddle_tpu.vision.models`` (VGG, MobileNet V1-V3,
AlexNet, DenseNet, GoogLeNet, InceptionV3, ShuffleNetV2, SqueezeNet) is
``pt.vision.models``, and the JAX package's other optimizers
(``pt.Adagrad``, ``pt.RMSProp``, ``pt.Adadelta``, ``pt.Adamax``,
``pt.Lamb``, ``pt.Rprop``, ``pt.LBFGS``) train them as the others do;
MobileNetV2 with the paper's RMSProp::

    model = pt.vision.models.mobilenet_v2(num_classes=1000)
    sched = pt.optimizer.lr.ExponentialDecay(0.045, gamma=0.98)
    opt = pt.RMSProp(sched, rho=0.9, momentum=0.9,
                     weight_decay=pt.regularizer.L2Decay(4e-5),
                     parameters=model.parameters(), multi_precision=True)

``params_from_paddle_tpu(state, model)`` fills a port model built in the
same configuration from a JAX model's ``state_dict()`` arrays
(BatchNorm's running statistics included).

The high-level API trains through ``pt.Model`` (``hapi``): ``fit`` stages
the step with ``jit.to_static``, reads batches through ``pt.io``'s
``DataLoader`` (worker processes, the native buffered reader), keeps
``pt.metric``'s metrics and the callbacks, and ``save`` / ``load`` write
the JAX package's file format (``pt.save`` / ``pt.load``)::

    model = pt.Model(pt.BertForSequenceClassification(
        pt.bert_base(dropout=0.0), num_classes=2))
    sched = pt.optimizer.lr.LinearWarmup(2e-5, 10, 0.0, 2e-5)
    model.prepare(pt.AdamW(sched, parameters=model.parameters(),
                           weight_decay=0.01),
                  pt.nn.CrossEntropyLoss(), pt.metric.Accuracy(),
                  amp_configs="O1")
    loader = pt.io.DataLoader(dataset, batch_size=32, num_workers=2)
    model.fit(loader, epochs=1, verbose=0,
              callbacks=[pt.hapi.callbacks.LRScheduler(by_step=True)])
    model.evaluate(eval_dataset, batch_size=32)
    model.save("ckpt/final")

Entry points run on ``cuda`` unless given ``device="cpu"`` and raise when
CUDA is absent (:mod:`.device`). The package imports neither ``jax`` nor
``paddle_tpu``.
"""
from . import (amp, distributed, framework, hapi, io, jit, metric, models,
               nn, optimizer, regularizer, vision)
from .amp import auto_cast
from .convert import (opt_state_from_paddle_tpu, opt_state_to_numpy,
                      params_from_paddle_tpu, params_to_numpy)
from .device import resolve_device
from .framework import load, save
from .hapi import Model, flops, summary
from .models import (BertConfig, BertForMaskedLM,
                     BertForSequenceClassification, BertModel, GPTConfig,
                     GPTForCausalLM, GPTPretrainingCriterion, LeNet, ResNet,
                     Seq2SeqTransformer, bert_base, bert_tiny, gpt_13b,
                     gpt_1p3b, gpt_small, gpt_tiny, resnet18, resnet34,
                     resnet50, resnet101, resnet152, resnext50_32x4d,
                     wide_resnet50_2)
from .ops.kernels import flash_attention_bshd
from .optimizer import (LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                        Lamb, Momentum, RMSProp, Rprop)
from .serving.engine import ServingEngine

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTPretrainingCriterion",
           "ServingEngine", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "RMSProp", "Adadelta", "Adamax", "Lamb", "Rprop", "LBFGS",
           "auto_cast",
           "flash_attention_bshd", "params_from_paddle_tpu",
           "params_to_numpy", "opt_state_from_paddle_tpu",
           "opt_state_to_numpy", "resolve_device", "amp", "distributed",
           "jit", "models", "nn", "optimizer", "regularizer", "vision",
           "gpt_tiny",
           "gpt_small", "gpt_1p3b", "gpt_13b", "LeNet", "ResNet",
           "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
           "resnext50_32x4d", "wide_resnet50_2", "BertConfig", "BertModel",
           "BertForSequenceClassification", "BertForMaskedLM", "bert_base",
           "bert_tiny", "Seq2SeqTransformer", "Model", "summary", "flops",
           "save", "load", "framework", "hapi", "io", "metric"]
