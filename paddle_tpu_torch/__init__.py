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

The tensor op surface of ``import paddle`` is the port's too, as plain
functions over ``torch.Tensor`` (``ops/``; no method is bound onto
torch's class) with the JAX package's names, defaults and output
dtypes, and the core API they stand on (dtypes, ``set_device``,
``seed``, ``to_tensor``, ``grad``)::

    import paddle_tpu_torch as paddle
    paddle.seed(0)
    x = paddle.to_tensor([[1.0, 2.0], [3.0, 4.0]], stop_gradient=False)
    y = paddle.matmul(x, x, transpose_y=True)
    a, b = paddle.split(y, 2, axis=-1)
    loss = paddle.sum(paddle.clip(a, 0.5) * b)
    (gx,) = paddle.grad(loss, [x])
    vals, idx = paddle.topk(paddle.rand([4, 8]), 3)
    q, r = paddle.linalg.qr(paddle.randn([5, 3]))

The core runtime modules are the JAX package's too: ``get_flags`` /
``set_flags``, the device runtime (``device.synchronize``, the memory
counters, ``Stream`` / ``Event`` / ``stream_guard``), ``autograd``
(``PyLayer``, ``jacobian`` / ``hessian`` / ``vjp`` / ``jvp``),
``amp.debugging`` (the tensor checker, operator statistics), ``utils``
(``run_check``, ``custom_op``) and ``incubate``'s fused surface, which
reaches the hand kernels as an LLM user's code calls them::

    from paddle_tpu_torch.incubate.nn import functional as IF
    h = IF.fused_rms_norm(x, w, None, 1e-6)               # RMSNorm kernel
    q, k, _ = IF.fused_rotary_position_embedding(q, k, None, sin=s, cos=c)
    o, _ = pt.incubate.flash_attention(q, k, v, causal=True)  # flash
    o = IF.block_multihead_attention(q1, k_pool, v_pool, None, lens, None,
                                     block_tables=bt)     # paged decode

Entry points run on ``cuda`` unless given ``device="cpu"`` and raise when
CUDA is absent (:mod:`.device`). The package imports neither ``jax`` nor
``paddle_tpu``.
"""
import torch

from . import (amp, autograd, distributed, framework, hapi, incubate, io, jit,
               linalg, metric, models, nn, ops, optimizer, regularizer,
               utils, vision)
from .amp import auto_cast
from .convert import (opt_state_from_paddle_tpu, opt_state_to_numpy,
                      params_from_paddle_tpu, params_to_numpy)
from .core.autograd import (enable_grad, grad, is_grad_enabled, no_grad,
                            set_grad_enabled)
from .core.dtype import (bfloat16, complex64, complex128, convert_dtype,
                         float16, float32, float64, get_default_dtype, int8,
                         int16, int32, int64, set_default_dtype, uint8)
from .core.dtype import bool_ as bool8
from .core.random import (get_cuda_rng_state, get_rng_state, seed,
                          set_cuda_rng_state, set_rng_state)
from .core.tensor import Parameter, Tensor, to_tensor
from .device import (CPUPlace, CUDAPlace, Place, TPUPlace, device_count,
                     get_device, is_compiled_with_tpu, resolve_device,
                     set_device)
from .framework import load, save
from .framework.flags import get_flags, set_flags
from .framework.compat import LazyGuard, batch, check_shape, create_parameter
from .framework.param_attr import ParamAttr
from .framework.dtype_info import (finfo, iinfo, is_complex,
                                   is_floating_point, is_integer)
from .hapi import Model, flops, summary
from .models import (BertConfig, BertForMaskedLM,
                     BertForSequenceClassification, BertModel, GPTConfig,
                     GPTForCausalLM, GPTPretrainingCriterion, LeNet, ResNet,
                     Seq2SeqTransformer, bert_base, bert_tiny, gpt_13b,
                     gpt_1p3b, gpt_small, gpt_tiny, resnet18, resnet34,
                     resnet50, resnet101, resnet152, resnext50_32x4d,
                     wide_resnet50_2)
from .core import random as prandom
from .ops import (creation, generated_root, inplace, logic, manipulation,
                  math, random_ops, search)
from .ops.kernels import flash_attention_bshd
from .optimizer import (LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                        Lamb, Momentum, RMSProp, Rprop)
from .serving.engine import ServingEngine
from . import inference, static  # noqa: E402


def disable_static(place=None):
    """Reference: paddle.disable_static — back to dygraph (eager) mode."""
    from .static.program import disable_static_mode
    disable_static_mode()


def enable_static():
    """Reference: paddle.enable_static — switch to Program recording: ops
    on ``paddle.static.data()`` Variables append to the default main
    Program; ``Executor.run(feed, fetch_list)`` evaluates it
    (``static/program.py``)."""
    from .static.program import enable_static_mode
    enable_static_mode()


def in_dynamic_mode():
    """False between :func:`enable_static` and :func:`disable_static`."""
    from .static.program import in_static_mode
    return not in_static_mode()


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Tensor print options (torch's ``set_printoptions``)."""
    torch.set_printoptions(precision=precision, threshold=threshold,
                           edgeitems=edgeitems, linewidth=linewidth,
                           sci_mode=sci_mode)


def disable_signal_handler():
    """Nothing to disable: the port installs no signal handler."""
    return None


def is_compiled_with_cuda():
    return True


def is_compiled_with_xpu():
    return False


def is_compiled_with_cinn():
    return False


def is_compiled_with_rocm():
    return torch.version.hip is not None


def is_compiled_with_custom_device(device_type="gpu"):
    return False


def is_grad_enabled_():
    return is_grad_enabled()


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
           "save", "load", "framework", "hapi", "incubate", "io", "metric",
           "linalg", "ops", "ParamAttr", "Parameter", "create_parameter",
           "LazyGuard", "batch", "check_shape",
           # the core API (dtypes, device, RNG, autograd, to_tensor)
           "Tensor", "to_tensor", "bfloat16", "bool", "bool8", "complex64",
           "complex128", "float16", "float32", "float64", "int8", "int16",
           "int32", "int64", "uint8", "get_default_dtype", "convert_dtype",
           "set_default_dtype", "finfo", "iinfo", "is_complex",
           "is_floating_point", "is_integer", "Place", "CPUPlace",
           "CUDAPlace", "set_device", "get_device", "device_count",
           "is_compiled_with_tpu", "seed", "get_rng_state", "set_rng_state",
           "get_cuda_rng_state", "set_cuda_rng_state", "grad", "no_grad",
           "enable_grad", "is_grad_enabled", "set_grad_enabled",
           "in_dynamic_mode", "set_printoptions", "enable_static",
           "disable_static", "static", "inference", "disable_signal_handler",
           "is_compiled_with_cuda", "is_compiled_with_xpu",
           "is_compiled_with_cinn", "is_compiled_with_rocm",
           "is_compiled_with_custom_device", "is_grad_enabled_",
           # the core runtime modules
           "autograd", "utils", "get_flags", "set_flags", "TPUPlace"]

# The op surface last: it holds ``sum``, ``max``, ``min``, ``abs``,
# ``round``, ``pow``, ``all``, ``any`` (and ``bool`` the dtype), which
# shadow the builtins from here on in this module.
__all__ += ops.__all__
globals().update({_n: getattr(ops, _n) for _n in ops.__all__})
bool = bool8  # noqa: A001
