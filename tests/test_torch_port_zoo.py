"""The port's vision zoo and the layers it brought against the JAX package.

Every activation the port has (``hardsigmoid`` at its JAX default slope
``0.1666667`` and at a given one), ``channel_shuffle`` in both layouts,
``concat``, every loss (each reduction, class ``weight``, ``soft_label``,
``label_smoothing``, ``ignore_index``, ``axis``, ``use_softmax``), the
activation and loss layers, the zoo's building blocks at small widths
(train-mode outputs and gradients, eval outputs) and one whole model of
every family at the smallest input its strides allow (eval logits and
cross-entropy; GoogLeNet's training triple too), each on the same numpy
inputs in both packages.

Weights go from the ``paddle_tpu`` model to the port through
``params_from_paddle_tpu``, BatchNorm scales, shifts and running
statistics perturbed first (as ``tests/test_torch_port_vision.py`` does)
and the convolution and linear biases drawn at random,
and dropout probabilities set to 0 on both sides where a case trains
(masks cannot match across packages). So that building the JAX models
does not compile a random initializer for every new shape, this file's
fixture draws their initial weights with numpy (normal, std
``1/sqrt(fan_in)``, constants as given); the weights then carry over as
always. The whole models' JAX forwards run as one XLA program each
(the JAX package's ``to_static`` machinery, ``_staged``), the blocks'
forwards and gradients eagerly. The DenseNet case adds a small
configuration (growth 8, blocks ``[2, 2, 2, 2]``, 16 stem channels) to
both classes' table under a new key: the same code as densenet121 at a
width the CPU runs quickly.

Tolerances: f32 ``rtol 1e-4 / atol 1e-5`` unless a case says otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.models.vision_zoo as JZ
import paddle_tpu.models.vision_zoo2 as JZ2
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.nn.initializer as JI
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.jit.api import StaticFunction
from paddle_tpu.ops.manipulation import concat as jax_concat

import paddle_tpu_torch as pt
import paddle_tpu_torch.models.vision_zoo as TZ
import paddle_tpu_torch.models.vision_zoo2 as TZ2
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.manipulation import concat
from paddle_tpu_torch import device as port_device

RTOL, ATOL = 1e-4, 1e-5



@pytest.fixture(autouse=True)
def _port_device():
    """Layers built without a device go to the CPU (the port's default is
    the card); the device is put back after each test."""
    before = port_device.DEFAULT_DEVICE
    port_device.DEFAULT_DEVICE = "cpu"
    yield
    port_device.DEFAULT_DEVICE = before


@pytest.fixture(autouse=True, scope="module")
def _numpy_init():
    """The JAX layers' initial weights drawn with numpy (see the module
    docstring); put back after the module."""
    rng = np.random.default_rng(1234)
    orig = JI.Initializer.__call__

    def draw(self, shape, dtype=None):
        shape = tuple(int(s) for s in shape)
        if isinstance(self, JI.Constant):
            return jnp.full(shape, self.value, jnp.float32)
        fan = JI._compute_fans(shape)[0]
        return jnp.asarray(rng.standard_normal(shape, dtype=np.float32)
                           / np.float32(np.sqrt(max(fan, 1))))

    JI.Initializer.__call__ = draw
    yield
    JI.Initializer.__call__ = orig


def _np(t):
    return np.asarray(t._data, np.float32) if isinstance(t, Tensor) else \
        t.detach().float().numpy()


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def _x(seed, *shape, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _j(a):
    return Tensor(jnp.asarray(a))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _perturb(jm, seed):
    """Random BatchNorm scales, shifts and running statistics, and random
    convolution and linear biases (initialised to 0, a mis-mapped bias
    would not show)."""
    rng = np.random.RandomState(seed)
    for _, layer in jm.named_sublayers(include_self=True):
        if not hasattr(layer, "_variance"):
            bias = getattr(layer, "bias", None)
            if bias is not None and isinstance(bias, Tensor):
                bias._data = jnp.asarray(
                    0.1 * rng.randn(*bias.shape), jnp.float32)
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
    pt.params_from_paddle_tpu(arrays, tm)
    for name, p in tm.named_parameters():
        p.param_name = name
    return tm


def _staged(jm):
    """``jm``'s forward as one XLA program (the JAX package's
    ``to_static`` without its control-flow converter, which these
    straight-line forwards do not need): the same function as the eager
    layer, compiled once instead of op by op. Forward only: the blocks'
    gradient checks run the JAX layers eagerly."""
    return StaticFunction(jm, convert_control_flow=False)


def _no_dropout(jm, tm):
    for _, layer in jm.named_sublayers(include_self=True):
        if isinstance(layer, jnn.Dropout):
            layer.p = 0.0
    for m in tm.modules():
        if isinstance(m, pt.nn.Dropout):
            m.p = 0.0


# ------------------------------------------------------------ activations
_ACTS = {
    "relu": ((), {}), "relu6": ((), {}), "gelu": ((), {}),
    "gelu_tanh": ((), {"approximate": True}), "sigmoid": ((), {}),
    "silu": ((), {}), "swish": ((), {}), "tanh": ((), {}),
    "leaky_relu": ((0.2,), {}), "elu": ((), {"alpha": 0.7}),
    "selu": ((), {}), "celu": ((), {"alpha": 1.5}),
    "hardtanh": ((-0.5, 2.0), {}), "hardsigmoid": ((), {}),
    "hardsigmoid_slope": ((), {"slope": 0.2, "offset": 0.4}),
    "hardswish": ((), {}), "hardshrink": ((), {"threshold": 0.7}),
    "softshrink": ((0.3,), {}), "tanhshrink": ((), {}),
    "softplus": ((), {}), "softplus_beta": ((2.0, 3.0), {}),
    "softsign": ((), {}), "mish": ((), {}), "log_sigmoid": ((), {}),
    "glu": ((), {"axis": 1}), "softmax": ((), {"axis": 0}),
    "softmax_dtype": ((), {"dtype": "float32"}), "log_softmax": ((), {}),
}


@pytest.mark.parametrize("case", sorted(_ACTS))
def test_activation_functionals_match_jax(case):
    """Forward values on inputs spread over each function's kinks (the
    clips at +-3 and 6, the shrink thresholds, softplus's linear tail)."""
    name = case.replace("_tanh", "").replace("_slope", "").replace(
        "_beta", "").replace("_dtype", "")
    args, kw = _ACTS[case]
    x = _x(1, 6, 8, scale=4.0)
    want = getattr(JF, name)(_j(x), *args, **kw)
    got = getattr(F, name)(_t(x), *args, **kw)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


def test_hardsigmoid_default_slope_is_jax_not_torch():
    """``0.1666667 x + 0.5``: at x = 2.9 it differs from torch's 1/6 in the
    seventh digit, and the port gives the JAX value."""
    x = torch.tensor([2.9999, -2.9999, 1.0])
    got = F.hardsigmoid(x)
    _close(got, JF.hardsigmoid(_j(x.numpy())))
    assert torch.equal(got, torch.clamp(x * 0.1666667 + 0.5, 0, 1))


@pytest.mark.parametrize("data_format,shape,n", [
    ("NCHW", (2, 4, 3, 3), 4), ("NHWC", (2, 3, 3, 4), 4),
    ("NCHW", (2, 4, 3, 3), 1)])
def test_prelu_broadcasts_over_the_channel_axis(data_format, shape, n):
    x = _x(2, *shape)
    w = _x(3, n, scale=0.3)
    _close(F.prelu(_t(x), _t(w), data_format),
           JF.prelu(_j(x), _j(w), data_format))
    jl = jnn.PReLU(n, init=0.1, data_format=data_format)
    tl = pt.nn.PReLU(n, init=0.1, data_format=data_format)
    _close(tl(_t(x)), jl(_j(x)))


def test_relu_and_clip_gradients_at_a_tie_are_jaxs():
    """At an input of exactly 0 (``relu``) or at a clip's bound half the
    gradient passes, as ``jnp.maximum`` / ``jnp.clip`` split it: each
    function's gradient at its ties and around them equals ``jax.grad``
    of the JAX function, and ``relu_`` (in place on a non-leaf) gives
    ``relu``'s."""
    x = np.array([-7, -3, -2, -1, 0, 1, 2, 3, 6, 7], np.float32)
    for name, kw in (("relu", {}), ("relu_", {}), ("relu6", {}),
                     ("hardtanh", {}), ("hardtanh", {"min": -2.0,
                                                     "max": 6.0}),
                     ("hardsigmoid", {"slope": 0.25}),
                     ("hardswish", {})):
        jname = "relu" if name == "relu_" else name
        want = jax.grad(lambda a: getattr(JF, jname)(
            Tensor(a), **kw)._data.sum())(jnp.asarray(x))
        tx = _t(x).requires_grad_(True)
        getattr(F, name)(tx * 1.0, **kw).sum().backward()
        np.testing.assert_array_equal(_np(tx.grad), np.asarray(want),
                                      err_msg=f"{name} {kw}")
    # the ties are there: half of the gradient passes at each
    tx = _t(x).requires_grad_(True)
    F.relu6(tx).sum().backward()
    assert _np(tx.grad)[[4, 8]].tolist() == [0.5, 0.5]


def test_relu_in_place():
    x = _t(_x(4, 3, 5))
    out = F.relu_(x)
    assert out is x and float(x.min()) == 0.0


_LAYERS = [("ReLU", ()), ("ReLU6", ()), ("GELU", (True,)), ("Sigmoid", ()),
           ("Tanh", ()), ("Softmax", (0,)), ("LogSoftmax", ()),
           ("LeakyReLU", (0.3,)), ("ELU", (0.5,)), ("SELU", ()),
           ("CELU", (2.0,)), ("Hardtanh", (-2.0, 0.5)),
           ("Hardsigmoid", ()), ("Hardswish", ()), ("Hardshrink", (0.2,)),
           ("Softshrink", ()), ("Tanhshrink", ()), ("Softplus", (1.5,)),
           ("Softsign", ()), ("Mish", ()), ("LogSigmoid", ()), ("Silu", ()),
           ("Swish", ()), ("GLU", (0,))]


@pytest.mark.parametrize("name,args", _LAYERS, ids=[n for n, _ in _LAYERS])
def test_activation_layers_match_jax(name, args):
    """Each layer, positional arguments mapped onto its functional's."""
    x = _x(5, 4, 6, scale=3.0)
    _close(getattr(pt.nn, name)(*args)(_t(x)),
           getattr(jnn, name)(*args)(_j(x)))


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_channel_shuffle_matches_jax(data_format):
    shape = (2, 6, 3, 4) if data_format == "NCHW" else (2, 3, 4, 6)
    x = _x(6, *shape)
    for g in (2, 3):
        got = F.channel_shuffle(_t(x), g, data_format)
        _close(got, JF.channel_shuffle(_j(x), g, data_format))
        _close(pt.nn.ChannelShuffle(g, data_format)(_t(x)), got)


def test_concat_matches_jax_and_casts_as_the_op():
    for axis, shape in ((1, (2, 0, 3)), (-1, (2, 3, 0)),
                        (torch.tensor([0]), (0, 3, 2))):
        xs = [_x(7 + i, *[d or 1 + i for d in shape]) for i in range(3)]
        jaxis = int(axis) if torch.is_tensor(axis) else axis
        _close(concat([_t(a) for a in xs], axis=axis),
               jax_concat([_j(a) for a in xs], axis=jaxis))
    with pt.auto_cast(level="O2", dtype="bfloat16"):
        out = concat([_t(xs[0]), _t(xs[0]).bfloat16()], axis=0)
    assert out.dtype == torch.bfloat16


# ------------------------------------------------------------------ losses
_N, _C = 6, 5


def _logits_labels(seed=11):
    rng = np.random.RandomState(seed)
    x = (2 * rng.randn(_N, _C)).astype(np.float32)
    y = rng.randint(0, _C, _N).astype(np.int64)
    y[1] = -100                                   # ignored
    return x, y


_CE_CASES = {
    "plain": {}, "sum": {"reduction": "sum"}, "none": {"reduction": "none"},
    "weight": {"weight": True}, "weight_sum": {"weight": True,
                                               "reduction": "sum"},
    "smoothing": {"label_smoothing": 0.1},
    "weight_smoothing": {"weight": True, "label_smoothing": 0.2},
    "ignore_3": {"ignore_index": 3}, "labels_n1": {"labels_n1": True},
    "soft": {"soft_label": True}, "soft_smoothing": {
        "soft_label": True, "label_smoothing": 0.1},
    "soft_none": {"soft_label": True, "reduction": "none"},
    "no_softmax": {"use_softmax": False}, "axis1": {"axis1": True},
}


@pytest.mark.parametrize("case", sorted(_CE_CASES))
def test_cross_entropy_matches_jax(case):
    kw = dict(_CE_CASES[case])
    x, y = _logits_labels()
    y[y == -100] = kw.get("ignore_index", -100)
    jx, tx = _j(x), _t(x)
    if kw.pop("weight", False):
        w = np.random.RandomState(12).rand(_C).astype(np.float32) + 0.5
        kw_j, kw_t = dict(kw, weight=_j(w)), dict(kw, weight=_t(w))
    else:
        kw_j, kw_t = dict(kw), dict(kw)
    if kw.get("soft_label"):
        p = np.random.RandomState(13).rand(_N, _C).astype(np.float32)
        y_j, y_t = _j(p / p.sum(1, keepdims=True)), _t(
            p / p.sum(1, keepdims=True))
    else:
        y_j, y_t = _j(y), _t(y)
    if kw_j.pop("labels_n1", None):
        kw_t.pop("labels_n1")
        y_j, y_t = _j(y[:, None]), _t(y[:, None])
    if kw_j.pop("use_softmax", True) is False:
        kw_t.pop("use_softmax")
        probs = np.exp(x) / np.exp(x).sum(1, keepdims=True)
        jx, tx = _j(probs), _t(probs)
        kw_j["use_softmax"] = kw_t["use_softmax"] = False
    if kw_j.pop("axis1", None):
        kw_t.pop("axis1")
        x3 = _x(14, 2, _C, 3)
        y3 = np.random.RandomState(15).randint(0, _C, (2, 3))
        jx, tx, y_j, y_t = _j(x3), _t(x3), _j(y3), _t(y3)
        kw_j["axis"] = kw_t["axis"] = 1
    got = F.cross_entropy(tx, y_t, **kw_t)
    want = JF.cross_entropy(jx, y_j, **kw_j)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)
    if case == "plain":
        layer = pt.nn.CrossEntropyLoss(label_smoothing=0.0)
        _close(layer(tx, y_t), want)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_other_losses_match_jax(reduction):
    """mse, l1, nll (with and without class weights), bce (with weights),
    bce with logits (with pos_weight and weights), smooth l1 (two deltas),
    kl_div (and ``batchmean``), margin ranking, square error, and
    softmax_with_cross_entropy."""
    rng = np.random.RandomState(16)
    a, b = _x(17, 4, 5), _x(18, 4, 5)
    p = (rng.rand(4, 5) * 0.98 + 0.01).astype(np.float32)
    y01 = (rng.rand(4, 5) > 0.5).astype(np.float32)
    w = (rng.rand(4, 5) + 0.5).astype(np.float32)
    pw = (rng.rand(5) + 0.5).astype(np.float32)
    logp = np.log(p / p.sum(1, keepdims=True)).astype(np.float32)
    lab = np.array([0, 3, 4, -100], np.int64)
    cw = (rng.rand(5) + 0.5).astype(np.float32)
    sign = np.where(rng.rand(4, 5) > 0.5, 1.0, -1.0).astype(np.float32)
    r = dict(reduction=reduction)
    pairs = [
        ("mse_loss", (a, b), r), ("l1_loss", (a, b), r),
        ("nll_loss", (logp, lab), r),
        ("nll_loss", (logp, lab, cw), r),
        ("binary_cross_entropy", (p, y01), r),
        ("binary_cross_entropy", (p, y01, w), r),
        ("binary_cross_entropy_with_logits", (a, y01), r),
        ("binary_cross_entropy_with_logits", (a, y01, w),
         dict(r, pos_weight=pw)),
        ("smooth_l1_loss", (a, b), r),
        ("smooth_l1_loss", (a, b), dict(r, delta=0.5)),
        ("kl_div", (logp, p), r),
        ("margin_ranking_loss", (a, b, sign), dict(r, margin=0.3)),
    ]
    for name, arrays, kw in pairs:
        kw = dict(kw)
        if "pos_weight" in kw:
            jkw = dict(kw, pos_weight=_j(kw["pos_weight"]))
            tkw = dict(kw, pos_weight=_t(kw["pos_weight"]))
        else:
            jkw = tkw = kw
        got = getattr(F, name)(*[_t(v) for v in arrays], **tkw)
        want = getattr(JF, name)(*[_j(v) for v in arrays], **jkw)
        assert tuple(got.shape) == tuple(want.shape), name
        _close(got, want, msg=name)
    if reduction == "mean":
        _close(F.kl_div(_t(logp), _t(p), "batchmean"),
               JF.kl_div(_j(logp), _j(p), "batchmean"))
        _close(F.square_error_cost(_t(a), _t(b)),
               JF.square_error_cost(_j(a), _j(b)))
        x, y = _logits_labels()
        for soft in (False, True):
            lab2 = _t(y[:, None]) if not soft else _t(np.eye(_C)[
                np.maximum(y, 0)].astype(np.float32))
            jlab2 = _j(_np(lab2) if soft else y[:, None])
            got, sm = F.softmax_with_cross_entropy(
                _t(x), lab2, soft_label=soft, return_softmax=True)
            want, jsm = JF.softmax_with_cross_entropy(
                _j(x), jlab2, soft_label=soft, return_softmax=True)
            _close(got, want)
            _close(sm, jsm)


def test_loss_layers_match_jax():
    a, b = _x(19, 3, 4), _x(20, 3, 4)
    p = np.clip(np.abs(a) / 3, 0.01, 0.99).astype(np.float32)
    y01 = (b > 0).astype(np.float32)
    logp = np.log(np.abs(a) / np.abs(a).sum(1, keepdims=True))
    lab = np.array([1, 0, 3], np.int64)
    sign = np.sign(b).astype(np.float32)
    for name, args, arrays in [
            ("MSELoss", ("sum",), (a, b)), ("L1Loss", (), (a, b)),
            ("NLLLoss", (), (logp.astype(np.float32), lab)),
            ("BCELoss", (), (p, y01)), ("BCEWithLogitsLoss", (), (a, y01)),
            ("SmoothL1Loss", ("mean", 0.4), (a, b)),
            ("KLDivLoss", ("sum",), (logp.astype(np.float32), p)),
            ("MarginRankingLoss", (0.2,), (a, b, sign))]:
        _close(getattr(pt.nn, name)(*args)(*[_t(v) for v in arrays]),
               getattr(jnn, name)(*args)(*[_j(v) for v in arrays]),
               msg=name)


def test_cross_entropy_is_the_one_the_models_call():
    """``nn.functional.cross_entropy`` is ``loss.cross_entropy``, which the
    criterion and ``common`` no longer define apart."""
    from paddle_tpu_torch.nn.functional import loss
    assert F.cross_entropy is loss.cross_entropy
    with pt.auto_cast(level="O2", dtype="bfloat16"):
        x = _t(_x(21, 4, 7)).bfloat16()
        out = F.cross_entropy(x, _t(np.array([1, 2, 3, 4])))
    assert out.dtype == torch.float32


# --------------------------------------------------------------- blocks
def _block_pair(jcls, tcls, args, seed):
    jb = _perturb(jcls(*args), seed)
    tb = _carry(jb, tcls(*args, device="cpu", dtype=torch.float32,
                         generator=None))
    return jb, tb


_BLOCKS = {
    "dense_layer": ("_DenseLayer", (12, 4, 2), (2, 12, 6, 6)),
    "inception_v1": ("_Inception", (16, 8, 6, 8, 4, 6, 4), (2, 16, 6, 6)),
    "inception_a": ("_InceptionA", (16, 8), (2, 16, 5, 5)),
    "reduction_a": ("_ReductionA", (16,), (2, 16, 7, 7)),
    "inception_b": ("_InceptionB", (16, 8), (2, 16, 5, 5)),
    "reduction_b": ("_ReductionB", (16,), (2, 16, 7, 7)),
    "inception_c": ("_InceptionC", (16,), (2, 16, 4, 4)),
    "se": ("_SE", (16,), (2, 16, 5, 5)),
    "mbv3_se_hardswish": ("_MBV3Block", (8, 16, 8, 3, 1, True,
                                         "hardswish"), (2, 8, 6, 6)),
    "mbv3_stride2_relu": ("_MBV3Block", (8, 24, 12, 5, 2, False, "relu"),
                          (2, 8, 7, 7)),
    "shuffle_unit_s1": ("_ShuffleUnit", (16, 16, 1, "relu"), (2, 16, 6, 6)),
    "shuffle_unit_s2_swish": ("_ShuffleUnit", (8, 16, 2, "swish"),
                              (2, 8, 6, 6)),
    "fire": ("_Fire", (12, 4, 6, 6), (2, 12, 5, 5)),
    "inverted_residual_res": ("_InvertedResidual", (8, 8, 1, 6),
                              (2, 8, 6, 6)),
    "inverted_residual_s2": ("_InvertedResidual", (8, 16, 2, 1),
                             (2, 8, 7, 7)),
}


@pytest.mark.parametrize("case", sorted(_BLOCKS))
def test_blocks_match_jax(case):
    """A block in train mode: its output, the gradients of a weighted sum
    of it with respect to its input and every parameter, and the running
    statistics after (the eval path is every family's case below)."""
    name, args, shape = _BLOCKS[case]
    mod_j, mod_t = (JZ, TZ) if name == "_InvertedResidual" else (JZ2, TZ2)
    jb, tb = _block_pair(getattr(mod_j, name), getattr(mod_t, name), args,
                         seed=len(case))
    x = _x(22, *shape)
    jx = Tensor(jnp.asarray(x), stop_gradient=False)
    tx = _t(x).requires_grad_(True)
    jout, tout = jb(jx), tb(tx)
    _close(tout, jout, msg="train output")
    w = _x(23, *tout.shape)
    (jout * _j(w)).sum().backward()
    (tout * _t(w)).sum().backward()
    _close(tx.grad, jx.grad, msg="input grad")
    jp = dict(jb.named_parameters())
    for pname, p in tb.named_parameters():
        _close(p.grad, jp[pname].grad, rtol=1e-4, atol=1e-4, msg=pname)
    want = {n: np.asarray(t._data) for n, t in jb.state_dict().items()}
    for bname, a in pt.params_to_numpy(tb).items():
        np.testing.assert_allclose(a, want[bname], rtol=RTOL, atol=ATOL,
                                   err_msg=bname)


# ---------------------------------------------------------------- models
_MODELS = {
    "vgg11_bn": (JZ.vgg11, TZ.vgg11, dict(batch_norm=True), 32),
    "mobilenet_v1": (JZ.MobileNetV1, TZ.MobileNetV1, dict(scale=0.25), 32),
    "mobilenet_v2": (JZ.MobileNetV2, TZ.MobileNetV2, dict(scale=0.25), 32),
    "alexnet": (JZ.alexnet, TZ.alexnet, {}, 224),
    "densenet_small": (JZ2.DenseNet, TZ2.DenseNet, dict(layers=10), 32),
    "inception_v3": (JZ2.inception_v3, TZ2.inception_v3, {}, 75),
    "mobilenet_v3_small": (JZ2.mobilenet_v3_small, TZ2.mobilenet_v3_small,
                           dict(scale=0.5), 32),
    "shufflenet_v2_x0_25": (JZ2.shufflenet_v2_x0_25,
                            TZ2.shufflenet_v2_x0_25, {}, 32),
    "squeezenet1_1": (JZ2.squeezenet1_1, TZ2.squeezenet1_1, {}, 32),
}


@pytest.fixture
def small_densenet(monkeypatch):
    for cls in (JZ2.DenseNet, TZ2.DenseNet):
        monkeypatch.setitem(cls._CFG, 10, (8, [2, 2, 2, 2], 16))


@pytest.mark.parametrize("case", sorted(_MODELS))
def test_zoo_families_match_jax(case, small_densenet):
    """One model of every family at B 2 and its smallest input: eval
    logits and their cross-entropy, on the perturbed statistics."""
    jf, tf, kw, hw = _MODELS[case]
    paddle.seed(24)
    jm = _perturb(jf(num_classes=7, **kw), 25)
    tm = _carry(jm, tf(num_classes=7, device="cpu", seed=None, **kw))
    jm.eval()
    tm.eval()
    x = _x(26, 2, 3, hw, hw)
    y = np.array([1, 6])
    jl, tl = _staged(jm)(_j(x)), tm(_t(x))
    assert tuple(tl.shape) == (2, 7)
    _close(tl, jl)
    _close(F.cross_entropy(tl, _t(y)), JF.cross_entropy(jl, _j(y)))


def test_googlenet_eval_and_its_training_triple_match_jax():
    """GoogLeNet at B 2 x 3 x 64 x 64: in eval its logits and their loss;
    in training ``(out, aux1, aux2)`` (dropout at 0 on both sides) and
    the summed loss. In training each batch norm of stage 5 normalises 8
    values a channel (B 2 at 2 x 2), which magnifies f32 rounding across
    its 57 batch norms (as ``tests/test_torch_port_vision.py``'s resnet18
    case says), so the training triple is held within ``rtol 1e-2 / atol
    5e-2``; the blocks' gradients are held above."""
    paddle.seed(27)
    jm = _perturb(JZ2.googlenet(num_classes=5), 27)
    tm = _carry(jm, TZ2.googlenet(num_classes=5, device="cpu", seed=None))
    _no_dropout(jm, tm)
    x = _x(28, 2, 3, 64, 64)
    y = np.array([0, 4])
    jf = _staged(jm)
    jm.eval()
    tm.eval()
    jl, tl = jf(_j(x)), tm(_t(x))
    assert tuple(tl.shape) == (2, 5)
    _close(tl, jl)
    _close(F.cross_entropy(tl, _t(y)), JF.cross_entropy(jl, _j(y)))
    jm.train()
    tm.train()
    jouts, touts = jf(_j(x)), tm(_t(x))
    assert isinstance(touts, tuple) and len(touts) == 3
    for got, want in zip(touts, jouts):
        _close(got, want, rtol=1e-2, atol=5e-2)
    jloss = sum((JF.cross_entropy(o, _j(y)) for o in jouts[1:]),
                JF.cross_entropy(jouts[0], _j(y)))
    tloss = sum(F.cross_entropy(o, _t(y)) for o in touts)
    _close(tloss, jloss, rtol=1e-2, atol=5e-2)


def test_vision_models_exports_the_jax_names():
    import paddle_tpu.vision.models as jvm
    import paddle_tpu_torch.vision.models as tvm
    want = {n for n in dir(jvm) if not n.startswith("_")
            and n not in ("annotations",)}
    got = {n for n in dir(tvm) if not n.startswith("_")}
    assert want <= got
