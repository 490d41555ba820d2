"""The port's ``nn.initializer`` against ``paddle_tpu.nn.initializer`` on
the CPU.

The deterministic parts are held exactly: ``Constant``, ``Assign``,
``calculate_gain``, ``_compute_fans`` and the order in which
``create_parameter`` takes its initializer (``ParamAttr``'s, then
``set_global_initializer``'s, then the layer's default, then
XavierUniform / Constant(0)). The random initializers draw from torch
generators, not JAX keys, so each is held by its support and its moments
over 131072 draws: the port's sample against the distribution's own
mean and standard deviation within five standard errors, and against
the JAX package's sample of the same initializer within the same bound.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.initializer as JI
from paddle_tpu.core.tensor import Tensor

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.initializer as TI
from paddle_tpu_torch import device as port_device
from paddle_tpu_torch.core import random as port_random

SHAPE = [256, 512]            # fans 256 / 512: 131072 draws


@pytest.fixture(autouse=True)
def _port_state():
    """Parameters on the CPU; the device, the framework RNG and both
    packages' global initializers restored."""
    before = port_device.DEFAULT_DEVICE
    port_device.DEFAULT_DEVICE = "cpu"
    yield
    port_device.DEFAULT_DEVICE = before
    port_random._reset_state()
    TI.set_global_initializer(None, None)
    JI.set_global_initializer(None, None)


def _np(t):
    if isinstance(t, Tensor):
        return np.asarray(t._data, np.float64)
    if isinstance(t, torch.Tensor):
        return t.detach().double().numpy()
    return np.asarray(t, np.float64)


# ------------------------------------------------------- deterministic
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_constant_equals_jax(dtype):
    got = TI.Constant(0.75)([3, 4], dtype)
    want = JI.Constant(0.75)([3, 4], dtype)
    assert got.dtype == pt.convert_dtype(dtype)
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float64))


@pytest.mark.parametrize("value", [
    np.arange(12, dtype=np.float32).reshape(3, 4),
    [[1.5, -2.0], [0.25, 4.0], [3.0, 1.0]],
    np.arange(12, dtype=np.float64)])
def test_assign_equals_jax(value):
    got = TI.Assign(value)([3, 4] if np.size(value) == 12 else [3, 2])
    want = JI.Assign(value)([3, 4] if np.size(value) == 12 else [3, 2])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float64))


def test_assign_copies_a_tensor():
    src = torch.ones(2, 3)
    out = TI.Assign(src)([2, 3])
    out.add_(1)
    assert torch.equal(src, torch.ones(2, 3))


@pytest.mark.parametrize("case", [
    ("sigmoid", None), ("linear", None), ("conv2d", None), ("tanh", None),
    ("relu", None), ("selu", None), ("leaky_relu", None),
    ("leaky_relu", 0.2), ("conv3d_transpose", None)])
def test_calculate_gain_equals_jax(case):
    assert TI.calculate_gain(*case) == JI.calculate_gain(*case)


def test_calculate_gain_refuses_what_jax_refuses():
    for mod in (TI, JI):
        with pytest.raises(ValueError):
            mod.calculate_gain("swish")


@pytest.mark.parametrize("shape", [[], [7], [3, 4], [8, 3, 3, 3],
                                   [16, 4, 5], [2, 3, 4, 5, 6]])
def test_compute_fans_equal_jax(shape):
    assert TI._compute_fans(shape) == JI._compute_fans(shape)


def _both_layers():
    """A Linear, a LayerNorm, an Embedding and a Conv2D in each package,
    the port's on the CPU."""
    return ([jnn.Linear(2, 3), jnn.LayerNorm(3), jnn.Embedding(4, 2),
             jnn.Conv2D(1, 2, 3)],
            [pt.nn.Linear(2, 3), pt.nn.LayerNorm(3), pt.nn.Embedding(4, 2),
             pt.nn.Conv2D(1, 2, 3)])


def _assert_same_params(jls, tls):
    for jl, tl in zip(jls, tls):
        want = {n: _np(p) for n, p in jl.named_parameters()}
        got = {n: _np(p) for n, p in tl.named_parameters()}
        assert got.keys() == want.keys()
        for name in want:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=f"{type(tl)} {name}")


def test_global_initializer_precedence_equals_jax():
    """The global initializers come before each layer's default (the
    LayerNorm's ones, the convolution's He normal) and after
    ``ParamAttr``'s; ``None`` drops them."""
    for mod in (TI, JI):
        mod.set_global_initializer(mod.Constant(2.0), mod.Constant(-3.0))
    jls, tls = _both_layers()
    _assert_same_params(jls, tls)
    assert _np(tls[1].weight)[0] == 2.0 and _np(tls[0].bias)[0] == -3.0
    attr_t = pt.ParamAttr(initializer=TI.Constant(5.0))
    attr_j = paddle.ParamAttr(initializer=JI.Constant(5.0))
    _assert_same_params([jnn.Linear(2, 3, attr_j, attr_j)],
                        [pt.nn.Linear(2, 3, attr_t, attr_t)])
    assert _np(pt.nn.Linear(2, 3, attr_t).weight)[0, 0] == 5.0
    for mod in (TI, JI):
        mod.set_global_initializer(None, None)
    jls, tls = _both_layers()
    for jl, tl in zip(jls[1:2], tls[1:2]):     # LayerNorm: ones, zeros
        _assert_same_params([jl], [tl])
    assert np.abs(_np(tls[0].bias)).max() == 0.0


def test_global_bias_initializer_alone():
    """A global weight initializer of None leaves the weights' defaults;
    the bias one still applies."""
    for mod in (TI, JI):
        mod.set_global_initializer(None, mod.Constant(0.5))
    jl, tl = jnn.Linear(3, 2), pt.nn.Linear(3, 2)
    np.testing.assert_array_equal(_np(tl.bias), _np(jl.bias))
    assert _np(tl.bias)[0] == 0.5
    assert np.abs(_np(tl.weight)).max() <= math.sqrt(6 / 5) + 1e-6


def test_op_style_aliases():
    assert TI.ConstantInitializer is TI.Constant
    assert TI.NormalInitializer is TI.Normal
    assert TI.UniformInitializer is TI.Uniform
    assert sorted(TI.__all__) == sorted(JI.__all__)


# ------------------------------------------------------------- random
def _truncnorm_moments(mean, std, a, b):
    pdf = lambda v: math.exp(-v * v / 2) / math.sqrt(2 * math.pi)  # noqa
    cdf = lambda v: 0.5 * (1 + math.erf(v / math.sqrt(2)))  # noqa
    z = cdf(b) - cdf(a)
    m = (pdf(a) - pdf(b)) / z
    var = 1 + (a * pdf(a) - b * pdf(b)) / z - m * m
    return mean + std * m, std * math.sqrt(var)


def _random_cases():
    """name -> (port init, JAX init, (mean, std), (low, high) support)."""
    f_in, f_out = SHAPE
    xn = math.sqrt(2.0 / (f_in + f_out))
    xu = math.sqrt(6.0 / (f_in + f_out))
    kn = math.sqrt(2.0) / math.sqrt(f_in)
    ku = math.sqrt(2.0) * math.sqrt(3.0 / f_in)
    inf = math.inf
    return {
        "Normal": (TI.Normal(1.0, 2.0), JI.Normal(1.0, 2.0), (1.0, 2.0),
                   (-inf, inf)),
        "TruncatedNormal": (
            TI.TruncatedNormal(0.5, 2.0, -1.5, 1.0),
            JI.TruncatedNormal(0.5, 2.0, -1.5, 1.0),
            _truncnorm_moments(0.5, 2.0, -1.5, 1.0), (-2.5, 2.5)),
        "TruncatedNormal_default": (
            TI.TruncatedNormal(std=0.02), JI.TruncatedNormal(std=0.02),
            _truncnorm_moments(0.0, 0.02, -2.0, 2.0), (-0.04, 0.04)),
        "Uniform": (TI.Uniform(-2.0, 3.0), JI.Uniform(-2.0, 3.0),
                    (0.5, 5.0 / math.sqrt(12)), (-2.0, 3.0)),
        "XavierNormal": (TI.XavierNormal(), JI.XavierNormal(), (0.0, xn),
                         (-inf, inf)),
        "XavierUniform": (TI.XavierUniform(), JI.XavierUniform(),
                          (0.0, xu / math.sqrt(3)), (-xu, xu)),
        "XavierUniform_gain": (
            TI.XavierUniform(fan_in=10, fan_out=20, gain=2.0),
            JI.XavierUniform(fan_in=10, fan_out=20, gain=2.0),
            (0.0, 2.0 * math.sqrt(6.0 / 30) / math.sqrt(3)),
            (-2.0 * math.sqrt(0.2), 2.0 * math.sqrt(0.2))),
        "KaimingNormal": (TI.KaimingNormal(), JI.KaimingNormal(), (0.0, kn),
                          (-inf, inf)),
        "KaimingUniform": (TI.KaimingUniform(), JI.KaimingUniform(),
                           (0.0, ku / math.sqrt(3)), (-ku, ku)),
        "KaimingNormal_leaky": (
            TI.KaimingNormal(negative_slope=0.2, nonlinearity="leaky_relu"),
            JI.KaimingNormal(negative_slope=0.2, nonlinearity="leaky_relu"),
            (0.0, math.sqrt(2.0 / 1.04) / math.sqrt(f_in)), (-inf, inf)),
    }


@pytest.mark.parametrize("name", sorted(_random_cases()))
def test_random_initializer_support_and_moments(name):
    tinit, jinit, (mean, std), (lo, hi) = _random_cases()[name]
    pt.seed(7)
    got = _np(tinit(SHAPE))
    want = _np(jinit(SHAPE, "float32"))
    assert got.shape == tuple(SHAPE)
    assert got.min() >= lo - 1e-6 and got.max() <= hi + 1e-6
    n = got.size
    for sample in (got, want):
        assert abs(sample.mean() - mean) <= 5 * std / math.sqrt(n)
        # the std of a sample std is about std / sqrt(2 n) (3x for the
        # flatter uniform and truncated laws is still far inside 5x)
        assert abs(sample.std() - std) <= 5 * std / math.sqrt(n / 2)
    assert abs(got.std() - want.std()) <= 10 * std / math.sqrt(n / 2)


@pytest.mark.parametrize("shape", [[64, 128], [128, 64], [16, 4, 3, 3]])
def test_orthogonal_is_orthogonal_as_in_jax(shape):
    rows, cols = shape[0], int(np.prod(shape[1:]))
    for init, dtype in ((TI.Orthogonal(gain=1.5), None),
                        (JI.Orthogonal(gain=1.5), "float32")):
        q = _np(init(shape, dtype)).reshape(rows, cols) / 1.5
        gram = q @ q.T if rows <= cols else q.T @ q
        np.testing.assert_allclose(gram, np.eye(min(rows, cols)),
                                   atol=1e-5)
    with pytest.raises(ValueError):
        TI.Orthogonal()([5])


@pytest.mark.parametrize("name", ["Normal", "Uniform", "XavierUniform",
                                  "TruncatedNormal"])
def test_seed_repeats_a_draw_and_a_generator_is_its_own(name):
    init = _random_cases()[name][0]
    pt.seed(11)
    a = init([32, 16])
    b = init([32, 16])
    pt.seed(11)
    assert torch.equal(init([32, 16]), a)
    assert not torch.equal(a, b)
    g = torch.Generator().manual_seed(5)
    c = init([32, 16], generator=g)
    g.manual_seed(5)
    assert torch.equal(init([32, 16], generator=g), c)
    pt.seed(11)
    init([32, 16], generator=g)             # leaves the framework stream
    assert torch.equal(init([32, 16]), a)


def test_random_draws_in_f32_and_casts():
    for dtype in ("bfloat16", "float16", "float64"):
        pt.seed(3)
        want = TI.XavierNormal()([8, 8])
        pt.seed(3)
        got = TI.XavierNormal()([8, 8], dtype)
        assert got.dtype == pt.convert_dtype(dtype)
        assert torch.equal(got, want.to(got.dtype))


def test_initializers_follow_the_current_device():
    port_device.DEFAULT_DEVICE = "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TI.Normal()([2, 2])
    assert TI.Normal()([2, 2], device="cpu").device.type == "cpu"
