"""The port's vision layers, models and SGD / Momentum vs the JAX package.

Weights go from a ``paddle_tpu`` model built from a seed (its BatchNorm
scales, shifts and running statistics perturbed, so a mis-mapped buffer
cannot hide) to the port through ``params_from_paddle_tpu``; inputs are
made with numpy. Tolerances are f32 ``rtol 1e-4 / atol 1e-5`` unless a
case says otherwise. Also here: the two repairs the vision slice needed,
``F.gelu``'s default (the exact erf form, as ``paddle_tpu``'s) and float16
AMP (the JAX package's op dtypes; an O2 f16 LeNet with
``Momentum(multi_precision=True)`` trained three steps in both packages).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.amp.auto_cast import amp_dtype_for as jax_amp_dtype_for
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models.resnet import BottleneckBlock as JaxBottleneck
from paddle_tpu.models import LeNet as JaxLeNet
from paddle_tpu.models import resnet18 as jax_resnet18

import paddle_tpu_torch as pt
from paddle_tpu_torch.amp import amp_lists
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch import device as port_device

amp_mod = importlib.import_module("paddle_tpu_torch.amp.auto_cast")

RTOL, ATOL = 1e-4, 1e-5



@pytest.fixture(autouse=True)
def _port_device():
    """Layers built without a device go to the CPU (the port's default is
    the card); the device is put back after each test."""
    before = port_device.DEFAULT_DEVICE
    port_device.DEFAULT_DEVICE = "cpu"
    yield
    port_device.DEFAULT_DEVICE = before


def _np(t):
    return np.asarray(t._data) if isinstance(t, Tensor) else \
        t.detach().float().numpy()


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _perturb(jm, seed):
    """Random BatchNorm scales, shifts and running statistics."""
    rng = np.random.RandomState(seed)
    for _, layer in jm.named_sublayers(include_self=True):
        if not hasattr(layer, "_variance"):
            continue
        c = layer._variance.shape[0]
        for t, value in ((layer.weight, 1 + 0.1 * rng.randn(c)),
                         (layer.bias, 0.1 * rng.randn(c)),
                         (layer._mean, 0.1 * rng.randn(c)),
                         (layer._variance, 1 + 0.2 * rng.rand(c))):
            t._data = jnp.asarray(value, jnp.float32)
    return jm


def _carry(jm, tm):
    arrays = {n: np.asarray(t._data) for n, t in jm.state_dict().items()}
    return pt.params_from_paddle_tpu(arrays, tm)


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ------------------------------------------------------------ functionals
_FUNCTIONAL = {
    "conv_plain": (lambda f, x, w: f.conv2d(x, w[0], w[1], padding=1),
                   (2, 3, 9, 9), [(4, 3, 3, 3), (4,)]),
    "conv_groups_stride": (lambda f, x, w: f.conv2d(x, w[0], None, stride=2,
                                                    padding=[1, 2],
                                                    groups=2),
                           (2, 4, 11, 10), [(6, 2, 3, 3)]),
    "conv_dilation_asym": (lambda f, x, w: f.conv2d(
        x, w[0], w[1], padding=[0, 1, 2, 1], dilation=2),
        (1, 3, 12, 12), [(5, 3, 3, 3), (5,)]),
    "conv_same_stride": (lambda f, x, w: f.conv2d(x, w[0], stride=2,
                                                  padding="SAME"),
                         (2, 3, 9, 8), [(4, 3, 3, 3)]),
    "conv_nhwc": (lambda f, x, w: f.conv2d(x, w[0], w[1], padding=1,
                                           data_format="NHWC"),
                  (2, 7, 6, 3), [(4, 3, 3, 3), (4,)]),
    "max_pool_pad": (lambda f, x, w: f.max_pool2d(x, 3, 2, padding=1),
                     (2, 3, 9, 9), []),
    "max_pool_ceil": (lambda f, x, w: f.max_pool2d(x, 3, 2, ceil_mode=True),
                      (2, 3, 10, 10), []),
    "max_pool_nhwc": (lambda f, x, w: f.max_pool2d(x, 2, 2,
                                                   data_format="NHWC"),
                      (2, 6, 6, 3), []),
    "avg_pool_exclusive": (lambda f, x, w: f.avg_pool2d(x, 3, 2, padding=1),
                           (2, 3, 9, 9), []),
    "avg_pool_inclusive": (lambda f, x, w: f.avg_pool2d(
        x, 3, 2, padding=1, exclusive=False), (2, 3, 9, 9), []),
    "avg_pool_ceil": (lambda f, x, w: f.avg_pool2d(x, 2, 2, ceil_mode=True),
                      (2, 3, 7, 7), []),
    "adaptive_even": (lambda f, x, w: f.adaptive_avg_pool2d(x, 1),
                      (2, 5, 7, 7), []),
    "adaptive_uneven": (lambda f, x, w: f.adaptive_avg_pool2d(x, [3, 2]),
                        (2, 5, 7, 5), []),
    "relu6_silu_sigmoid_tanh": (lambda f, x, w: f.tanh(f.sigmoid(f.silu(
        f.relu6(x * 4)))), (3, 40), []),
}


@pytest.mark.parametrize("case", sorted(_FUNCTIONAL))
def test_functionals_match_jax(case):
    fn, xshape, wshapes = _FUNCTIONAL[case]
    x = _x(1, *xshape)
    ws = [_x(2 + i, *s) for i, s in enumerate(wshapes)]
    want = fn(JF, Tensor(jnp.asarray(x)), [Tensor(jnp.asarray(w))
                                            for w in ws])
    got = fn(F, torch.from_numpy(x), [torch.from_numpy(w) for w in ws])
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


@pytest.mark.parametrize("data_format,shape", [("NCHW", (4, 3, 5, 6)),
                                               ("NHWC", (4, 5, 6, 3)),
                                               ("NC", (16, 3)),
                                               ("NC", (1, 3))])
def test_batch_norm_train_three_calls_then_eval_matches_jax(data_format,
                                                           shape):
    """Training: the output of each of three calls and the running
    statistics after them (Paddle's momentum, biased variance; one value
    a channel too, whose variance is 0); then eval on the running
    statistics."""
    c = 3
    rng = np.random.RandomState(3)
    w, b = 1 + 0.1 * rng.randn(c), 0.1 * rng.randn(c)
    rm, rv = 0.1 * rng.randn(c), 1 + 0.2 * rng.rand(c)
    jt = [Tensor(jnp.asarray(a, jnp.float32)) for a in (w, b, rm, rv)]
    tt = [torch.tensor(a, dtype=torch.float32) for a in (w, b, rm, rv)]
    for i in range(3):
        x = 2 * _x(10 + i, *shape) + 0.5
        want = JF.batch_norm(Tensor(jnp.asarray(x)), jt[2], jt[3], jt[0],
                             jt[1], training=True, momentum=0.9,
                             data_format=data_format)
        got = F.batch_norm(torch.from_numpy(x), tt[2], tt[3], tt[0], tt[1],
                           training=True, momentum=0.9,
                           data_format=data_format)
        _close(got, want)
    _close(tt[2], jt[2])
    _close(tt[3], jt[3])
    x = _x(20, *shape)
    _close(F.batch_norm(torch.from_numpy(x), tt[2], tt[3], tt[0], tt[1],
                        data_format=data_format),
           JF.batch_norm(Tensor(jnp.asarray(x)), jt[2], jt[3], jt[0], jt[1],
                         data_format=data_format))


def test_gelu_defaults_to_the_exact_form_as_jax():
    """``F.gelu(x)`` is the erf form, as ``paddle_tpu``'s (the tanh form
    differs by up to ~1e-3 on these inputs); ``approximate=True`` is the
    tanh form of both."""
    x = np.linspace(-5, 5, 2001).astype(np.float32)
    for kw in ({}, {"approximate": True}):
        np.testing.assert_allclose(
            _np(F.gelu(torch.from_numpy(x), **kw)),
            _np(JF.gelu(Tensor(jnp.asarray(x)), **kw)), rtol=0, atol=1e-6)
    assert float((F.gelu(torch.from_numpy(x)) - F.gelu(
        torch.from_numpy(x), approximate=True)).abs().max()) > 1e-4


# ----------------------------------------------------------------- models
def _lenet_pair(seed):
    paddle.seed(seed)
    jm = JaxLeNet()
    return jm, _carry(jm, pt.LeNet(device="cpu", seed=None))


def test_lenet_forward_and_loss_match_jax():
    jm, tm = _lenet_pair(30)
    x = _x(31, 4, 1, 28, 28)
    y = np.random.RandomState(32).randint(0, 10, 4)
    jl, tl = jm(Tensor(jnp.asarray(x))), tm(torch.from_numpy(x))
    _close(tl, jl)
    _close(F.cross_entropy(tl, torch.from_numpy(y)),
           JF.cross_entropy(jl, Tensor(jnp.asarray(y))))


def _loss_pair(jm, tm, x, y):
    jl, tl = jm(Tensor(jnp.asarray(x))), tm(torch.from_numpy(x))
    return (jl, tl, JF.cross_entropy(jl, Tensor(jnp.asarray(y))),
            F.cross_entropy(tl, torch.from_numpy(y)))


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_resnet18_matches_jax(mode):
    """``resnet18(num_classes=7)`` at 2 x 3 x 32 x 32: logits and loss, in
    train mode over three calls with the running statistics after them.
    In train mode layer4 normalises two values a channel (batch 2 at
    1 x 1), and where they nearly agree batch norm divides f32 rounding
    by ``sqrt(var + 1e-5)`` (as little as 3e-3): there the logits are held
    within atol 5e-2 and layer4's running statistics within atol 1e-4;
    eval mode and every other statistic are held at the usual tolerance."""
    paddle.seed(33)
    jm = _perturb(jax_resnet18(num_classes=7), 34)
    tm = _carry(jm, pt.resnet18(num_classes=7, device="cpu", seed=None))
    getattr(jm, mode)()
    getattr(tm, mode)()
    train = mode == "train"
    for i in range(3 if train else 1):
        x = _x(35 + i, 2, 3, 32, 32)
        y = np.random.RandomState(38 + i).randint(0, 7, 2)
        jl, tl, jloss, tloss = _loss_pair(jm, tm, x, y)
        tol = dict(rtol=1e-2, atol=5e-2) if train else {}
        _close(tl, jl, **tol)
        _close(tloss, jloss, **tol)
    want = {n: np.asarray(t._data) for n, t in jm.state_dict().items()}
    got = pt.params_to_numpy(tm)
    assert set(got) == set(want)
    for name in want:
        atol = 1e-4 if train and name.startswith("layer4") else ATOL
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("groups,base_width,stride", [(1, 64, 2),
                                                      (32, 4, 1)])
def test_bottleneck_blocks_match_jax(groups, base_width, stride):
    """A BottleneckBlock with a strided 1x1 downsample, and
    ``resnext50_32x4d``'s grouped block (256 channels in, 32 groups of
    width 4 at planes 64: its ``layer1.1``), in train mode: output, input
    gradient and running statistics."""
    paddle.seed(40)
    inplanes, planes = (64 if stride != 1 else 256), 64
    down = None
    tdown = None
    if stride != 1:
        down = paddle.nn.Sequential(
            paddle.nn.Conv2D(inplanes, planes * 4, 1, stride=stride,
                             bias_attr=False),
            paddle.nn.BatchNorm2D(planes * 4))
        tdown = pt.nn.Sequential(
            pt.nn.Conv2D(inplanes, planes * 4, 1, stride=stride,
                         bias_attr=False),
            pt.nn.BatchNorm2D(planes * 4))
    jb = _perturb(JaxBottleneck(inplanes, planes, stride, down,
                                groups=groups, base_width=base_width), 41)
    tb = _carry(jb, pt.models.BottleneckBlock(
        inplanes, planes, stride, tdown, groups=groups,
        base_width=base_width))
    x = _x(42, 2, inplanes, 8, 8)
    xj = Tensor(jnp.asarray(x), stop_gradient=False)
    xt = torch.from_numpy(x).requires_grad_(True)
    jo, to = jb(xj), tb(xt)
    _close(to, jo)
    (jo * jo).sum().backward()
    (to * to).sum().backward()
    _close(xt.grad, xj.grad, rtol=1e-4, atol=1e-4)
    want = {n: np.asarray(t._data) for n, t in jb.state_dict().items()}
    for name, a in pt.params_to_numpy(tb).items():
        np.testing.assert_allclose(a, want[name], rtol=RTOL, atol=ATOL,
                                   err_msg=name)


# ------------------------------------------------------------- optimizers
def _train_both(make_opts, steps=3, seed=50, level=None, dtype=None):
    """``steps`` steps of LeNet in both packages on the same numpy batches
    -> (jax model, port model, jax opt, port opt, jax losses, port
    losses)."""
    jm, tm = _lenet_pair(seed)
    jopt, topt = make_opts(jm, tm)
    if level == "O2":
        jm, jopt = paddle.amp.decorate(models=jm, optimizers=jopt,
                                       level="O2", dtype=dtype)
        tm, topt = pt.amp.decorate(tm, topt, level="O2", dtype=dtype)
    rng = np.random.RandomState(seed + 1)
    jlosses, tlosses = [], []
    for _ in range(steps):
        x = rng.randn(8, 1, 28, 28).astype(np.float32)
        y = rng.randint(0, 10, 8)
        if level:
            with paddle.amp.auto_cast(level=level, dtype=dtype):
                jloss = JF.cross_entropy(jm(Tensor(jnp.asarray(x))),
                                         Tensor(jnp.asarray(y)))
            with pt.auto_cast(level=level, dtype=dtype):
                tloss = F.cross_entropy(tm(torch.from_numpy(x)),
                                        torch.from_numpy(y))
        else:
            jl, tl, jloss, tloss = _loss_pair(jm, tm, x, y)
        jloss.backward()
        jopt.step()
        jopt.clear_grad()
        tloss.backward()
        topt.step()
        topt.clear_grad()
        jlosses.append(float(np.asarray(jloss._data)))
        tlosses.append(float(tloss.detach()))
    return jm, tm, jopt, topt, jlosses, tlosses


def _jax_state(jopt, jm):
    names = {p.name: n for n, p in jm.named_parameters()}
    state = {k: np.asarray(v._data) if isinstance(v, Tensor) else v
             for k, v in jopt.state_dict().items()
             if k != "master_weights"}
    return pt.opt_state_from_paddle_tpu(state, names)


@pytest.mark.parametrize("kind", ["momentum_nesterov_l2", "momentum",
                                  "sgd_l2"])
def test_three_optimizer_steps_on_lenet_match_jax(kind):
    """Weights after each package's three steps, the ``velocity``
    accumulators and the ``state_dict`` keys (JAX's, renamed to the
    structured names by ``opt_state_from_paddle_tpu``)."""
    decay = 1e-3 if kind.endswith("l2") else None

    def make(jm, tm):
        jwd = paddle.regularizer.L2Decay(decay) if decay else None
        twd = pt.regularizer.L2Decay(decay) if decay else None
        if kind == "sgd_l2":
            return (paddle.optimizer.SGD(0.05, jm.parameters(),
                                         weight_decay=jwd),
                    pt.SGD(0.05, tm.parameters(), weight_decay=twd))
        nesterov = "nesterov" in kind
        return (paddle.optimizer.Momentum(0.05, 0.9, jm.parameters(),
                                          use_nesterov=nesterov,
                                          weight_decay=jwd),
                pt.Momentum(0.05, 0.9, tm.parameters(),
                            use_nesterov=nesterov, weight_decay=twd))

    jm, tm, jopt, topt, jl, tl = _train_both(make)
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    want = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    for name, a in pt.params_to_numpy(tm).items():
        np.testing.assert_allclose(a, want[name], rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    jstate, tstate = _jax_state(jopt, jm), topt.state_dict()
    assert set(jstate) == set(tstate)
    if kind != "sgd_l2":
        assert {k for k in tstate if k.endswith("_velocity")} == {
            f"{n}_velocity" for n in want}
    for key, value in jstate.items():
        if torch.is_tensor(value):
            np.testing.assert_allclose(_np(tstate[key]), _np(value),
                                       rtol=RTOL, atol=ATOL, err_msg=key)


# ---------------------------------------------------------------- float16
_F16_OPS = amp_lists.WHITE_LIST | amp_lists.BLACK_LIST | {
    "gelu", "lm_head_tied", "embedding", "relu", "max_pool2d", "add",
    "adaptive_avg_pool2d", "conv2d", "batch_norm"}


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_float16_auto_cast_gives_each_op_the_jax_dtype(level):
    """Under ``auto_cast(dtype="float16")`` every op name the port casts
    by gets the dtype the JAX package's ``amp_dtype_for`` gives it."""
    for name in sorted(_F16_OPS):
        with paddle.amp.auto_cast(level=level, dtype="float16"):
            want = jax_amp_dtype_for(name)
        with pt.auto_cast(level=level, dtype="float16"):
            got = amp_mod.amp_dtype_for(name)
        assert (None if want is None else str(jnp.dtype(want))) == (
            None if got is None else str(got).replace("torch.", "")), name


def test_float16_o2_lenet_momentum_masters_match_jax():
    """O2 float16 ``decorate`` of LeNet with ``Momentum(multi_precision=
    True)``, three steps in both packages: f16 parameters with f32
    masters; the losses within f16 precision of each other (rtol 5e-3: a
    few f16 roundings of the logits); each port parameter exactly its
    master rounded to f16, as each JAX one is."""

    def make(jm, tm):
        return (paddle.optimizer.Momentum(0.05, 0.9, jm.parameters(),
                                          multi_precision=True),
                pt.Momentum(0.05, 0.9, tm.parameters(),
                            multi_precision=True))

    jm, tm, jopt, topt, jl, tl = _train_both(make, level="O2",
                                             dtype="float16")
    np.testing.assert_allclose(tl, jl, rtol=5e-3)
    assert all(p.dtype == torch.float16 for p in tm.parameters())
    assert set(topt._master_weights) == set(tm.parameters())
    for p in tm.parameters():
        master = topt._master_weights[p]
        assert master.dtype == torch.float32
        assert torch.equal(p.detach(), master.to(torch.float16))
    for p in jm.parameters():
        master = jopt._master_weights[id(p)]
        assert str(p._data.dtype) == "float16"
        np.testing.assert_array_equal(np.asarray(p._data),
                                      np.asarray(master).astype(np.float16))


def test_float16_adamw_master_mode_writes_f16_parameters():
    """AdamW on decorated f16 parameters (the fused kernel's plain version
    on the CPU): f32 masters and moments, each parameter its master
    rounded to f16; the same step in the JAX package within f32 rounding
    of the masters."""
    jm, tm = _lenet_pair(60)
    jopt = paddle.optimizer.AdamW(1e-3, parameters=jm.parameters(),
                                  multi_precision=True)
    topt = pt.AdamW(1e-3, parameters=tm.parameters(), multi_precision=True)
    paddle.amp.decorate(models=jm, optimizers=jopt, level="O2",
                        dtype="float16")
    pt.amp.decorate(tm, topt, level="O2", dtype="float16")
    rng = np.random.RandomState(61)
    jparams = dict(jm.named_parameters())
    for name, p in tm.named_parameters():
        g = torch.from_numpy(0.01 * rng.randn(*p.shape).astype(
            np.float32)).half()
        p.grad = g
        jparams[name]._grad = jnp.asarray(g.float().numpy(), jnp.float16)
    jopt.step()
    topt.step()
    for name, p in tm.named_parameters():
        master = topt._master_weights[p]
        assert torch.equal(p.detach(), master.half())
        for acc in ("moment1", "moment2"):
            assert topt._accumulators[acc][p].dtype == torch.float32
        np.testing.assert_allclose(
            master.numpy(), np.asarray(jopt._master_weights[id(
                jparams[name])]), rtol=0, atol=1e-6, err_msg=name)
