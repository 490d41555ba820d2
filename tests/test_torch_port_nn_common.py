"""The port's padding, resizing, sampling, folding and dropout functionals
against the JAX package's on the CPU: forward values, dtypes and input
gradients from numpy-made inputs within ``rtol / atol 1e-5`` (f32). The
random ones (``dropout2d`` / ``dropout3d`` / ``alpha_dropout``,
``rrelu``, ``gumbel_softmax``) draw from other generators than JAX's, so
they are held to their support and moments instead."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import device as port_device

from torch_nn_parity import check, rand


@pytest.fixture(autouse=True)
def _port_device():
    before = port_device.DEFAULT_DEVICE
    port_device.DEFAULT_DEVICE = "cpu"
    yield
    port_device.DEFAULT_DEVICE = before


PAD_CASES = [
    ((2, 3, 6), dict(pad=[2, 1], mode="constant", value=0.5,
                     data_format="NCL")),
    ((2, 3, 6), dict(pad=[2, 3], mode="reflect", data_format="NCL")),
    ((2, 3, 5, 6), dict(pad=[1, 2, 0, 3], mode="replicate")),
    ((2, 3, 5, 6), dict(pad=[3, 1, 2, 2], mode="circular")),
    ((2, 5, 6, 3), dict(pad=[1, 2, 3, 0], mode="reflect",
                        data_format="NHWC")),
    ((1, 2, 3, 4, 5), dict(pad=[1, 0, 2, 1, 0, 2], mode="replicate",
                           data_format="NCDHW")),
    ((2, 3, 4), dict(pad=[0, 1, 1, 0, 2, 3], mode="constant")),
    ((2, 3, 4), dict(pad=[0, 0, 1, 1, 6, 5], mode="reflect")),
    ((2, 6, 16), dict(pad=[15, 16], data_format="NCL")),
]


@pytest.mark.parametrize("xs,kw", PAD_CASES,
                         ids=[f"{c[1]['mode'] if 'mode' in c[1] else 'c'}-{i}"
                              for i, c in enumerate(PAD_CASES)])
def test_pad_equals_jax(xs, kw):
    """``pad`` pairs the last spatial axis first; a list with two entries
    a dimension pads every dimension, first to last; ``reflect`` past an
    axis' length reflects again, as numpy's does."""
    check(lambda a: JF.pad(a, **kw), lambda a: TF.pad(a, **kw),
          [rand(1, *xs)])


INTERP_CASES = [
    ((2, 3, 5, 7), dict(size=[10, 14], mode="nearest")),
    ((2, 3, 9, 8), dict(size=[4, 3], mode="nearest")),
    ((2, 3, 5, 7), dict(scale_factor=2, mode="bilinear")),
    ((2, 3, 5, 7), dict(size=[8, 11], mode="bilinear", align_corners=True)),
    ((2, 3, 12, 10), dict(size=[5, 4], mode="bilinear")),
    ((2, 3, 6, 6), dict(size=[9, 13], mode="bicubic")),
    ((2, 3, 11, 9), dict(size=[4, 4], mode="bicubic")),
    ((2, 3, 7), dict(size=12, mode="linear", data_format="NCL")),
    ((1, 2, 3, 4, 5), dict(scale_factor=[2, 1.5, 1], mode="trilinear",
                           data_format="NCDHW")),
    ((2, 3, 8, 8), dict(size=[3, 5], mode="area")),
]


@pytest.mark.parametrize("xs,kw", INTERP_CASES,
                         ids=[f"{c[1]['mode']}-{i}"
                              for i, c in enumerate(INTERP_CASES)])
def test_interpolate_equals_jax(xs, kw):
    """``jax.image.resize``: half-pixel sampling, antialiased shrinking,
    Keys' cubic; ``align_corners`` changes nothing."""
    check(lambda a: JF.interpolate(a, **kw),
          lambda a: TF.interpolate(a, **kw), [rand(2, *xs)])


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample_equals_jax(mode, padding_mode, align_corners):
    """A grid reaching past the input on every side."""
    x = rand(3, 2, 3, 5, 6)
    g = (np.random.RandomState(4).rand(2, 4, 7, 2) * 2.6 - 1.3).astype(
        np.float32)
    kw = dict(mode=mode, padding_mode=padding_mode,
              align_corners=align_corners)
    check(lambda a, b: JF.grid_sample(a, b, **kw),
          lambda a, b: TF.grid_sample(a, b, **kw), [x, g], atol=2e-5,
          rtol=2e-5)


@pytest.mark.parametrize("align_corners", [True, False])
def test_affine_grid_equals_jax(align_corners):
    theta = rand(5, 2, 2, 3)
    check(lambda t: JF.affine_grid(t, [2, 3, 4, 5], align_corners),
          lambda t: TF.affine_grid(t, [2, 3, 4, 5], align_corners), [theta])


@pytest.mark.parametrize("kw", [
    dict(kernel_sizes=3),
    dict(kernel_sizes=[2, 3], strides=[2, 1], paddings=1, dilations=[1, 2]),
])
def test_unfold_and_fold_equal_jax(kw):
    x = rand(6, 2, 3, 7, 8)
    out = check(lambda a: JF.unfold(a, **kw), lambda a: TF.unfold(a, **kw),
                [x])[0][0]
    check(lambda a: JF.fold(a, [7, 8], **kw),
          lambda a: TF.fold(a, [7, 8], **kw), [out])


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_pixel_shuffle_and_temporal_shift_equal_jax(fmt):
    x = rand(7, 4, 8, 3, 4) if fmt == "NCHW" else rand(7, 4, 3, 4, 8)
    check(lambda a: JF.pixel_shuffle(a, 2, fmt),
          lambda a: TF.pixel_shuffle(a, 2, fmt), [x])
    y = rand(8, 2, 4, 6, 6) if fmt == "NCHW" else rand(8, 2, 6, 6, 4)
    check(lambda a: JF.pixel_unshuffle(a, 2, fmt),
          lambda a: TF.pixel_unshuffle(a, 2, fmt), [y])
    check(lambda a: JF.temporal_shift(a, 2, 0.25, fmt),
          lambda a: TF.temporal_shift(a, 2, 0.25, fmt), [x])


def test_small_common_ops_equal_jax():
    a, b = rand(9, 4, 6), rand(10, 4, 6)
    check(lambda u, v: JF.cosine_similarity(u, v, axis=1),
          lambda u, v: TF.cosine_similarity(u, v, axis=1), [a, b])
    lab = np.eye(5, dtype=np.float32)[[0, 3, 1]]
    prior = np.full((5,), 0.2, np.float32)
    check(lambda y: JF.label_smooth(y, epsilon=0.2),
          lambda y: TF.label_smooth(y, epsilon=0.2), [lab])
    check(lambda y, p: JF.label_smooth(y, p, 0.1),
          lambda y, p: TF.label_smooth(y, p, 0.1), [lab, prior])
    check(lambda u: JF.zeropad2d(u, [1, 2, 0, 3]),
          lambda u: TF.zeropad2d(u, [1, 2, 0, 3]), [rand(11, 1, 2, 3, 4)])


def test_pad_and_upsample_layers_equal_jax():
    x = rand(12, 2, 3, 5, 6)
    for jl, tl in ((paddle.nn.Pad2D([1, 0, 2, 1], mode="reflect"),
                    pt.nn.Pad2D([1, 0, 2, 1], mode="reflect")),
                   (paddle.nn.UpsamplingBilinear2D(scale_factor=2),
                    pt.nn.UpsamplingBilinear2D(scale_factor=2)),
                   (paddle.nn.Upsample(size=[3, 4], mode="bicubic"),
                    pt.nn.Upsample(size=[3, 4], mode="bicubic")),
                   (paddle.nn.UpsamplingNearest2D(size=[7, 9]),
                    pt.nn.UpsamplingNearest2D(size=[7, 9]))):
        check(jl, tl, [x])
    check(paddle.nn.Pad1D([2, 1], mode="replicate"),
          pt.nn.Pad1D([2, 1], mode="replicate"), [rand(13, 2, 3, 5)])
    check(paddle.nn.Pad3D([1] * 6), pt.nn.Pad3D([1] * 6),
          [rand(14, 1, 2, 2, 3, 2)])
    check(paddle.nn.CosineSimilarity(axis=-1),
          pt.nn.CosineSimilarity(axis=-1), [rand(15, 3, 4), rand(16, 3, 4)])


@pytest.mark.parametrize("fn,fmt,shape,axes", [
    ("dropout2d", "NCHW", (64, 32, 3, 3), (0, 1)),
    ("dropout2d", "NHWC", (64, 3, 3, 32), (0, 3)),
    ("dropout3d", "NCDHW", (64, 32, 2, 2, 2), (0, 1)),
])
def test_channel_dropout_support_and_moments(fn, fmt, shape, axes):
    """Whole channels drop, each with probability ``p``; the kept ones
    are scaled by ``1 / (1 - p)``; outside training it is the identity."""
    x = torch.ones(shape)
    g = torch.Generator().manual_seed(0)
    y = getattr(TF, fn)(x, 0.3, True, fmt, generator=g)
    vals = torch.unique(y).numpy()
    assert len(vals) == 2 and vals[0] == 0.0
    np.testing.assert_allclose(vals[1], 1 / 0.7, rtol=1e-6)
    red = tuple(i for i in range(len(shape)) if i not in axes)
    per = y.amax(red)
    assert torch.equal(y.amin(red), per)             # one mask a channel
    keep = float((per > 0).float().mean())
    assert abs(keep - 0.7) < 4 * (0.21 / per.numel()) ** 0.5
    assert torch.equal(getattr(TF, fn)(x, 0.3, False, fmt), x)


def test_alpha_dropout_keeps_the_moments_of_a_selu_input():
    """``alpha_dropout`` of a zero-mean unit-variance input keeps both
    moments (within four standard errors), as SELU's self-normalisation
    needs."""
    x = torch.from_numpy(rand(16, 400, 500))
    y = TF.alpha_dropout(x, 0.2, generator=torch.Generator().manual_seed(1))
    n = y.numel()
    assert abs(float(y.mean())) < 4 / n ** 0.5
    assert abs(float(y.var()) - 1.0) < 4 * (2 / n) ** 0.5 + 1e-3
    q, alpha = 0.8, -1.7580993408473766
    a = (q + alpha ** 2 * q * 0.2) ** -0.5
    dropped = float(((y - (a * alpha - a * alpha * 0.2)).abs() < 1e-6)
                    .float().mean())
    assert abs(dropped - 0.2) < 0.005
    assert torch.equal(TF.alpha_dropout(x, 0.2, training=False), x)
