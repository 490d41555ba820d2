"""The port's convolutions, transposed convolutions, pools and unpools
against the JAX package's on the CPU: forward values, dtypes and the
gradient of every floating input, from numpy-made inputs, within ``rtol /
atol 1e-5`` in f32 (``2e-5`` for the 3-D cases, whose sums are longer).
The layers are built in both packages and carried by
``params_from_paddle_tpu``; under ``auto_cast`` O1 the convolutions run
in bf16 (the white list), the pools keep the input's type."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import device as port_device

from torch_nn_parity import check, rand, to_np


@pytest.fixture(autouse=True)
def _port_device():
    before = port_device.DEFAULT_DEVICE
    port_device.DEFAULT_DEVICE = "cpu"
    yield
    port_device.DEFAULT_DEVICE = before


CONV_CASES = [
    # nd, x shape, w shape, kwargs
    (1, (2, 4, 11), (6, 4, 3), dict(stride=2, padding=1)),
    (1, (2, 4, 11), (4, 1, 5), dict(padding=[1, 3], groups=4)),
    (1, (2, 11, 4), (6, 4, 3), dict(padding="SAME", data_format="NLC")),
    (1, (2, 6, 16), (6, 1, 32), dict(padding=[15, 16], groups=6)),
    (2, (2, 3, 9, 8), (4, 3, 3, 3), dict(stride=[2, 1], dilation=2)),
    (2, (2, 4, 9, 8), (6, 2, 3, 2), dict(padding=[1, 2, 0, 1], groups=2)),
    (2, (2, 9, 8, 3), (4, 3, 3, 3), dict(padding="SAME", stride=2,
                                         data_format="NHWC")),
    (2, (1, 2, 7, 7), (3, 2, 3, 3), dict(padding=[[0, 0], [0, 0], [1, 0],
                                                  [2, 1]])),
    (3, (1, 2, 5, 6, 7), (3, 2, 2, 3, 3), dict(stride=2, padding=1)),
    (3, (1, 5, 6, 7, 2), (4, 2, 3, 3, 3), dict(padding="VALID",
                                               data_format="NDHWC")),
]


@pytest.mark.parametrize("nd,xs,ws,kw", CONV_CASES,
                         ids=[f"conv{c[0]}d-{i}"
                              for i, c in enumerate(CONV_CASES)])
def test_conv_equals_jax(nd, xs, ws, kw):
    x, w, b = rand(1, *xs), rand(2, *ws, scale=0.3), rand(3, ws[0])
    tol = 2e-5 if nd == 3 else 1e-5
    check(lambda *a: getattr(JF, f"conv{nd}d")(*a, **kw),
          lambda *a: getattr(TF, f"conv{nd}d")(*a, **kw), [x, w, b],
          rtol=tol, atol=tol)


TRANSPOSE_CASES = [
    (1, (2, 4, 7), (4, 3, 3), dict(stride=2, padding=1, output_padding=1)),
    (1, (2, 4, 7), (4, 2, 4), dict(stride=3, padding=[0, 2], groups=2)),
    (2, (2, 4, 5, 6), (4, 3, 3, 3), dict(stride=2, padding=1,
                                         output_padding=1)),
    (2, (2, 4, 5, 6), (4, 1, 3, 2), dict(stride=[2, 3], dilation=2,
                                         groups=4, padding=[1, 0])),
    (2, (2, 5, 6, 4), (4, 3, 3, 3), dict(stride=2, output_padding=[1, 0],
                                         data_format="NHWC")),
    (2, (1, 2, 4, 4), (2, 3, 3, 3), dict(stride=1, padding=[0, 1, 2, 0],
                                         output_padding=1)),
    (3, (1, 2, 3, 4, 5), (2, 3, 2, 3, 3), dict(stride=2, padding=1)),
]


@pytest.mark.parametrize("nd,xs,ws,kw", TRANSPOSE_CASES,
                         ids=[f"conv{c[0]}d_transpose-{i}"
                              for i, c in enumerate(TRANSPOSE_CASES)])
def test_conv_transpose_equals_jax(nd, xs, ws, kw):
    """Weights [in, out / groups, k...]; asymmetric padding and an
    ``output_padding`` at or past torch's own limit take the port's
    crop path and must still give JAX's values."""
    x, w, b = rand(4, *xs), rand(5, *ws, scale=0.3), rand(6, ws[1] * kw.get(
        "groups", 1))
    tol = 2e-5 if nd == 3 else 1e-5
    check(lambda *a: getattr(JF, f"conv{nd}d_transpose")(*a, **kw),
          lambda *a: getattr(TF, f"conv{nd}d_transpose")(*a, **kw),
          [x, w, b], rtol=tol, atol=tol)


def test_conv_transpose_output_size_is_checked_as_in_jax():
    x, w = torch.zeros(1, 2, 4), torch.zeros(2, 3, 3)
    assert TF.conv1d_transpose(x, w, stride=2, output_size=[9]).shape[-1] \
        == 9
    with pytest.raises(ValueError):
        TF.conv1d_transpose(x, w, stride=2, output_size=[10])
    with pytest.raises(NotImplementedError):
        TF.conv1d_transpose(x, w, padding="SAME")


POOL_CASES = [
    ("max_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2, padding=1)),
    ("max_pool1d", (2, 3, 11), dict(kernel_size=4, stride=3,
                                    ceil_mode=True)),
    ("avg_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2, padding=1)),
    ("avg_pool1d", (2, 3, 11), dict(kernel_size=3, padding=1,
                                    exclusive=False)),
    ("max_pool2d", (2, 3, 9, 8), dict(kernel_size=3, stride=2, padding=1,
                                      ceil_mode=True)),
    ("avg_pool2d", (2, 9, 8, 3), dict(kernel_size=2, stride=2,
                                      data_format="NHWC")),
    ("max_pool3d", (1, 2, 5, 6, 7), dict(kernel_size=2, stride=2,
                                         padding=1)),
    ("avg_pool3d", (1, 2, 5, 6, 7), dict(kernel_size=3, stride=2,
                                         padding=1, ceil_mode=True)),
    ("avg_pool3d", (1, 2, 4, 4, 4), dict(kernel_size=2)),
    ("adaptive_avg_pool1d", (2, 3, 10), dict(output_size=4)),
    ("adaptive_avg_pool1d", (2, 3, 12), dict(output_size=4)),
    ("adaptive_max_pool1d", (2, 3, 10), dict(output_size=3)),
    ("adaptive_max_pool2d", (2, 3, 9, 7), dict(output_size=[4, 3])),
    ("adaptive_avg_pool2d", (2, 7, 9, 3), dict(output_size=2,
                                               data_format="NHWC")),
    ("adaptive_avg_pool3d", (1, 2, 5, 6, 7), dict(output_size=[2, 3, 4])),
    ("adaptive_max_pool3d", (1, 2, 5, 6, 7), dict(output_size=[2, 3, 2])),
]


@pytest.mark.parametrize("name,xs,kw", POOL_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(POOL_CASES)])
def test_pool_equals_jax(name, xs, kw):
    x = rand(7, *xs)
    check(lambda a: getattr(JF, name)(a, **kw),
          lambda a: getattr(TF, name)(a, **kw), [x])


@pytest.mark.parametrize("nd,xs,kw", [
    (1, (2, 3, 10), dict(kernel_size=2)),
    (2, (2, 3, 8, 6), dict(kernel_size=2, stride=2)),
    (2, (1, 2, 7, 7), dict(kernel_size=3, stride=2)),
    (3, (1, 2, 4, 6, 4), dict(kernel_size=2)),
])
def test_max_unpool_equals_jax(nd, xs, kw):
    """The port's ``max_pool{nd}d(return_mask=True)`` gives flat spatial
    indices; both packages' ``max_unpool{nd}d`` scatter by them, to JAX's
    default size ``(in - 1) * stride + kernel``."""
    x = rand(8, *xs)
    pooled, idx = getattr(TF, f"max_pool{nd}d")(torch.from_numpy(x),
                                                return_mask=True, **kw)
    check(lambda a, i: getattr(JF, f"max_unpool{nd}d")(a, i, **kw),
          lambda a, i: getattr(TF, f"max_unpool{nd}d")(a, i, **kw),
          [pooled.numpy(), idx.numpy()])


def test_max_pool_mask_indexes_the_unpadded_input():
    """``return_mask`` (the port's extension) with padding and
    ``ceil_mode``: every index names an input element equal to its
    output."""
    x = torch.from_numpy(rand(9, 2, 3, 7, 9))
    out, idx = TF.max_pool2d(x, 3, stride=2, padding=1, ceil_mode=True,
                             return_mask=True)
    flat = x.reshape(2, 3, -1)
    assert torch.equal(flat.gather(2, idx.reshape(2, 3, -1)),
                       out.reshape(2, 3, -1))
    out1, idx1 = TF.adaptive_max_pool2d(x, [3, 4], return_mask=True)
    assert torch.equal(flat.gather(2, idx1.reshape(2, 3, -1)),
                       out1.reshape(2, 3, -1))


LAYER_CASES = [
    ("Conv1D", (4, 6, 3), dict(stride=2, padding=1), (2, 4, 9)),
    ("Conv3D", (2, 3, 2), dict(padding=1), (1, 2, 4, 5, 3)),
    ("Conv1DTranspose", (4, 6, 3), dict(stride=2, output_padding=1),
     (2, 4, 5)),
    ("Conv2DTranspose", (4, 2, 3), dict(stride=2, groups=2, padding=1),
     (2, 4, 5, 5)),
    ("Conv3DTranspose", (2, 3, 2), dict(stride=2), (1, 2, 3, 3, 3)),
]


@pytest.mark.parametrize("name,args,kw,xs", LAYER_CASES,
                         ids=[c[0] for c in LAYER_CASES])
def test_conv_layer_with_carried_weights_equals_jax(name, args, kw, xs):
    """JAX's parameter names and layouts carry over by name alone; the
    forward and the weight's gradient match."""
    jl = getattr(paddle.nn, name)(*args, **kw)
    tl = getattr(pt.nn, name)(*args, **kw)
    assert [n for n, _ in jl.named_parameters()] == \
        [n for n, _ in tl.named_parameters()]
    pt.params_from_paddle_tpu(
        {n: np.asarray(t._data) for n, t in jl.state_dict().items()}, tl)
    x = rand(10, *xs)
    jy = jl(paddle.to_tensor(x))
    ty = tl(torch.from_numpy(x))
    np.testing.assert_allclose(ty.detach().numpy(), to_np(jy), rtol=2e-5,
                               atol=2e-5)
    jy.sum().backward()
    ty.sum().backward()
    np.testing.assert_allclose(tl.weight.grad.numpy(), to_np(jl.weight.grad),
                               rtol=2e-5, atol=2e-5)


def test_conv_layer_default_init_is_jax_normal():
    """A convolution's default weight is ``Normal(0, sqrt(2 / fan_in))``;
    a transposed one's XavierUniform (``conv.py:44-50``)."""
    pt.seed(0)
    w = pt.nn.Conv1D(64, 128, 5).weight.detach()
    assert abs(float(w.std()) - (2.0 / (5 * 64)) ** 0.5) < 4e-3
    wt = pt.nn.Conv1DTranspose(64, 32, 5).weight.detach()
    jt = paddle.nn.Conv1DTranspose(64, 32, 5).weight
    assert abs(float(wt.std()) - float(np.asarray(jt._data).std())) < 3e-3


@pytest.mark.parametrize("name,kind", [("conv1d", "conv"),
                                       ("conv2d_transpose", "conv"),
                                       ("avg_pool1d", "pool"),
                                       ("max_pool3d", "pool")])
def test_dtypes_under_o1_equal_jax(name, kind):
    """Under ``auto_cast`` O1 bf16 a convolution (white list) computes in
    bf16 from f32 inputs, as in JAX; a pool keeps f32."""
    if kind == "conv":
        nd = int(name[4])
        x = rand(11, *((1, 2) + (5,) * nd))
        w = rand(12, *((2, 2) + (3,) * nd))
        jargs, targs = (paddle.to_tensor(x), paddle.to_tensor(w)), \
            (torch.from_numpy(x), torch.from_numpy(w))
    else:
        nd = int(name[-2])
        x = rand(11, *((1, 2) + (6,) * nd))
        jargs, targs = (paddle.to_tensor(x), 2), (torch.from_numpy(x), 2)
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        jy = getattr(JF, name)(*jargs)
    with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
        ty = getattr(TF, name)(*targs)
    assert str(np.asarray(jy._data).dtype) == \
        str(ty.dtype).replace("torch.", "")
    np.testing.assert_allclose(ty.float().detach().numpy(),
                               np.asarray(jy._data).astype(np.float32),
                               rtol=2e-2, atol=2e-2)
