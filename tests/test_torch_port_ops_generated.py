"""AUTO-GENERATED golden tests by paddle_tpu_torch/ops/gen.py — DO NOT EDIT.

The port's registry ops against the numpy goldens of the JAX package's
registry (``paddle_tpu/ops/ops.yaml``), on the CPU, with the tolerance
each entry states; and the committed generated files against the
generator's output.
"""
import os

import numpy as np
import pytest

import paddle_tpu_torch as paddle
from paddle_tpu_torch import device as _device


@pytest.fixture(autouse=True)
def _on_cpu():
    before = _device.DEFAULT_DEVICE
    _device.DEFAULT_DEVICE = "cpu"
    yield
    _device.DEFAULT_DEVICE = before


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach")
                      else x)


def test_generated_files_are_current():
    from paddle_tpu_torch.ops.gen import generate
    for path, content in generate(write=False).items():
        with open(path) as f:
            assert f.read() == content, (
                f"{os.path.basename(path)} is stale: run "
                "python -m paddle_tpu_torch.ops.gen")



def test_root_abs_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 4))
    out = paddle.abs(paddle.to_tensor(x))
    expect = np.abs(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_neg_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 4))
    out = paddle.neg(paddle.to_tensor(x))
    expect = -x
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_exp_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 4))
    out = paddle.exp(paddle.to_tensor(x))
    expect = np.exp(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_expm1_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 4))
    out = paddle.expm1(paddle.to_tensor(x))
    expect = np.expm1(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_log_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.rand(3, 4) + 0.1)
    out = paddle.log(paddle.to_tensor(x))
    expect = np.log(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_log2_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.rand(3, 4) + 0.1)
    out = paddle.log2(paddle.to_tensor(x))
    expect = np.log2(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_log10_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.rand(3, 4) + 0.1)
    out = paddle.log10(paddle.to_tensor(x))
    expect = np.log10(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_log1p_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.rand(3, 4))
    out = paddle.log1p(paddle.to_tensor(x))
    expect = np.log1p(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_sqrt_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.rand(3, 4))
    out = paddle.sqrt(paddle.to_tensor(x))
    expect = np.sqrt(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_rsqrt_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.rand(3, 4) + 0.1)
    out = paddle.rsqrt(paddle.to_tensor(x))
    expect = 1/np.sqrt(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_square_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 4))
    out = paddle.square(paddle.to_tensor(x))
    expect = x*x
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_sin_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 4))
    out = paddle.sin(paddle.to_tensor(x))
    expect = np.sin(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_cos_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 4))
    out = paddle.cos(paddle.to_tensor(x))
    expect = np.cos(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_tan_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 4))
    out = paddle.tan(paddle.to_tensor(x))
    expect = np.tan(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_asin_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.rand(3, 4) * 1.8 - 0.9)
    out = paddle.asin(paddle.to_tensor(x))
    expect = np.arcsin(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_acos_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.rand(3, 4) * 1.8 - 0.9)
    out = paddle.acos(paddle.to_tensor(x))
    expect = np.arccos(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_atan_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 4))
    out = paddle.atan(paddle.to_tensor(x))
    expect = np.arctan(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_sinh_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 4))
    out = paddle.sinh(paddle.to_tensor(x))
    expect = np.sinh(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_cosh_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 4))
    out = paddle.cosh(paddle.to_tensor(x))
    expect = np.cosh(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_tanh_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 4))
    out = paddle.tanh(paddle.to_tensor(x))
    expect = np.tanh(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_asinh_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 4))
    out = paddle.asinh(paddle.to_tensor(x))
    expect = np.arcsinh(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_acosh_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.rand(3, 4) + 1.1)
    out = paddle.acosh(paddle.to_tensor(x))
    expect = np.arccosh(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_atanh_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.rand(3, 4) * 1.6 - 0.8)
    out = paddle.atanh(paddle.to_tensor(x))
    expect = np.arctanh(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_ceil_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 4) * 3)
    out = paddle.ceil(paddle.to_tensor(x))
    expect = np.ceil(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_floor_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 4) * 3)
    out = paddle.floor(paddle.to_tensor(x))
    expect = np.floor(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_round_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 4) * 3)
    out = paddle.round(paddle.to_tensor(x))
    expect = np.round(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_trunc_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 4) * 3)
    out = paddle.trunc(paddle.to_tensor(x))
    expect = np.trunc(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_frac_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 4) * 3)
    out = paddle.frac(paddle.to_tensor(x))
    expect = x - np.trunc(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_sign_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 4))
    out = paddle.sign(paddle.to_tensor(x))
    expect = np.sign(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_reciprocal_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.rand(3, 4) + 0.5)
    out = paddle.reciprocal(paddle.to_tensor(x))
    expect = 1.0/x
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_sigmoid_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 4))
    out = paddle.sigmoid(paddle.to_tensor(x))
    expect = 1/(1+np.exp(-x))
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_logit_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.rand(3, 4) * 0.8 + 0.1)
    out = paddle.logit(paddle.to_tensor(x))
    expect = np.log(x/(1-x))
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_deg2rad_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 4) * 90)
    out = paddle.deg2rad(paddle.to_tensor(x))
    expect = np.deg2rad(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_rad2deg_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 4))
    out = paddle.rad2deg(paddle.to_tensor(x))
    expect = np.rad2deg(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_quantile_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(4, 6))
    out = paddle.quantile(paddle.to_tensor(x), q=0.5)
    expect = np.quantile(x, 0.5)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_nanquantile_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(np.where(rng.rand(4, 6) < 0.3, np.nan, rng.randn(4, 6)))
    out = paddle.nanquantile(paddle.to_tensor(x), q=0.25)
    expect = np.nanquantile(x, 0.25)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_logcumsumexp_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(5, 3))
    out = paddle.logcumsumexp(paddle.to_tensor(x), axis=0)
    expect = np.log(np.cumsum(np.exp(x), axis=0))
    np.testing.assert_allclose(_np(out), expect, rtol=1e-4, atol=1e-4)


def test_root_diff_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(4, 6))
    out = paddle.diff(paddle.to_tensor(x))
    expect = np.diff(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_trapezoid_golden():
    rng = np.random.RandomState(0)
    y = np.asarray(rng.randn(4, 6))
    out = paddle.trapezoid(paddle.to_tensor(y))
    expect = np.trapezoid(y, axis=-1)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-5, atol=1e-5)


def test_root_signbit_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 4))
    out = paddle.signbit(paddle.to_tensor(x))
    expect = np.signbit(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_frexp_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.rand(3, 4) * 8 + 0.5)
    out = paddle.frexp(paddle.to_tensor(x))
    expect = np.frexp(x)
    for o, ex in zip(out, expect):
        np.testing.assert_allclose(_np(o), ex, rtol=1e-05, atol=1e-05)


def test_root_ldexp_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 4))
    y = np.asarray(rng.randint(-3, 3, (3, 4)))
    out = paddle.ldexp(paddle.to_tensor(x), paddle.to_tensor(y))
    expect = np.ldexp(x, y)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_vander_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(5))
    out = paddle.vander(paddle.to_tensor(x))
    expect = np.vander(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_isposinf_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(np.array([1.0, np.inf, -np.inf, np.nan]))
    out = paddle.isposinf(paddle.to_tensor(x))
    expect = np.isposinf(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_isneginf_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(np.array([1.0, np.inf, -np.inf, np.nan]))
    out = paddle.isneginf(paddle.to_tensor(x))
    expect = np.isneginf(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_baddbmm_golden():
    rng = np.random.RandomState(0)
    input = np.asarray(rng.randn(2, 3, 5))
    x = np.asarray(rng.randn(2, 3, 4))
    y = np.asarray(rng.randn(2, 4, 5))
    out = paddle.baddbmm(paddle.to_tensor(input), paddle.to_tensor(x), paddle.to_tensor(y))
    expect = input + np.matmul(x, y)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-4, atol=1e-4)


def test_root_cdist_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(4, 3))
    y = np.asarray(rng.randn(5, 3))
    out = paddle.cdist(paddle.to_tensor(x), paddle.to_tensor(y))
    expect = np.sqrt(((x[:, None, :] - y[None, :, :])**2).sum(-1))
    np.testing.assert_allclose(_np(out), expect, rtol=1e-4, atol=1e-4)


def test_root_histc_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.rand(50))
    out = paddle.histc(paddle.to_tensor(x), bins=10, min=0.0, max=1.0)
    expect = np.histogram(x, bins=10, range=(0.0, 1.0))[0].astype('float64')
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_take_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 4))
    index = np.asarray(rng.randint(0, 12, (5,)))
    out = paddle.take(paddle.to_tensor(x), paddle.to_tensor(index))
    expect = x.reshape(-1)[index]
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_unfold_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(8))
    out = paddle.unfold(paddle.to_tensor(x), axis=0, size=4, step=2)
    expect = np.stack([x[0:4], x[2:6], x[4:8]])
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_diagonal_scatter_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(4, 4))
    y = np.asarray(rng.randn(4))
    out = paddle.diagonal_scatter(paddle.to_tensor(x), paddle.to_tensor(y))
    expect = x * (1 - np.eye(4)) + np.diag(y)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-6, atol=1e-6)


def test_root_select_scatter_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 4))
    values = np.asarray(rng.randn(4))
    out = paddle.select_scatter(paddle.to_tensor(x), paddle.to_tensor(values), axis=0, index=1)
    expect = np.concatenate([x[:1], values[None], x[2:]])
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_slice_scatter_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(6, 4))
    value = np.asarray(rng.randn(2, 4))
    out = paddle.slice_scatter(paddle.to_tensor(x), paddle.to_tensor(value), axes=[0], starts=[1], ends=[5], strides=[2])
    expect = np.concatenate([x[:1], value[:1], x[2:3], value[1:], x[4:]])
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_vecdot_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 4))
    y = np.asarray(rng.randn(3, 4))
    out = paddle.vecdot(paddle.to_tensor(x), paddle.to_tensor(y))
    expect = (x * y).sum(-1)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-5, atol=1e-5)


def test_root_column_stack_golden():
    rng = np.random.RandomState(0)
    x = [np.asarray(_e) for _e in ([rng.randn(4), rng.randn(4)])]
    out = paddle.column_stack([paddle.to_tensor(_e) for _e in x])
    expect = np.column_stack(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_hstack_golden():
    rng = np.random.RandomState(0)
    x = [np.asarray(_e) for _e in ([rng.randn(3, 2), rng.randn(3, 5)])]
    out = paddle.hstack([paddle.to_tensor(_e) for _e in x])
    expect = np.hstack(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_vstack_golden():
    rng = np.random.RandomState(0)
    x = [np.asarray(_e) for _e in ([rng.randn(2, 4), rng.randn(3, 4)])]
    out = paddle.vstack([paddle.to_tensor(_e) for _e in x])
    expect = np.vstack(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_bitwise_left_shift_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randint(0, 16, (3, 4)))
    y = np.asarray(rng.randint(0, 4, (3, 4)))
    out = paddle.bitwise_left_shift(paddle.to_tensor(x), paddle.to_tensor(y))
    expect = np.left_shift(x, y)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_bitwise_right_shift_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randint(0, 64, (3, 4)))
    y = np.asarray(rng.randint(0, 4, (3, 4)))
    out = paddle.bitwise_right_shift(paddle.to_tensor(x), paddle.to_tensor(y))
    expect = np.right_shift(x, y)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_linalg_cond_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(4, 4) + np.eye(4) * 3)
    out = paddle.linalg.cond(paddle.to_tensor(x))
    expect = np.linalg.cond(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-3, atol=1e-3)


def test_linalg_matrix_exp_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 3) * 0.3)
    out = paddle.linalg.matrix_exp(paddle.to_tensor(x))
    expect = __import__('scipy.linalg', fromlist=['expm']).expm(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-4, atol=1e-4)


def test_root_add_n_golden():
    rng = np.random.RandomState(0)
    inputs = [np.asarray(_e) for _e in (rng.randn(2, 3), rng.randn(2, 3), rng.randn(2, 3))]
    out = paddle.add_n([paddle.to_tensor(_e) for _e in inputs])
    expect = inputs[0] + inputs[1] + inputs[2]
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_sgn_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 4))
    out = paddle.sgn(paddle.to_tensor(x))
    expect = np.sign(x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_unflatten_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(4, 6))
    out = paddle.unflatten(paddle.to_tensor(x), axis=1, shape=[2, 3])
    expect = x.reshape(4, 2, 3)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_reverse_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 4))
    out = paddle.reverse(paddle.to_tensor(x), axis=0)
    expect = x[::-1]
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_masked_scatter_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(2, 3))
    mask = np.asarray(np.array([[1, 0, 1], [0, 1, 0]], bool))
    value = np.asarray(rng.randn(6))
    out = paddle.masked_scatter(paddle.to_tensor(x), paddle.to_tensor(mask), paddle.to_tensor(value))
    expect = np.where(mask, np.where(mask.ravel(), value[np.maximum(np.cumsum(mask.ravel())-1, 0)], 0).reshape(2, 3), x)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_pdist_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(4, 3))
    out = paddle.pdist(paddle.to_tensor(x))
    expect = np.array([np.linalg.norm(x[i]-x[j]) for i in range(4) for j in range(i+1, 4)])
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_shard_index_golden():
    rng = np.random.RandomState(0)
    input = np.asarray(np.array([[1], [6], [12], [19]], np.int64))
    out = paddle.shard_index(paddle.to_tensor(input), index_num=20, nshards=2, shard_id=0)
    expect = np.array([[1], [6], [-1], [-1]])
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_rank_golden():
    rng = np.random.RandomState(0)
    input = np.asarray(rng.randn(2, 3, 4))
    out = paddle.rank(paddle.to_tensor(input))
    expect = 3
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_shape_golden():
    rng = np.random.RandomState(0)
    input = np.asarray(rng.randn(2, 5))
    out = paddle.shape(paddle.to_tensor(input))
    expect = np.array([2, 5])
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_combinations_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(np.arange(4.0))
    out = paddle.combinations(paddle.to_tensor(x), r=2)
    expect = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.float64)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_logaddexp2_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(3, 4))
    y = np.asarray(rng.randn(3, 4))
    out = paddle.logaddexp2(paddle.to_tensor(x), paddle.to_tensor(y))
    expect = np.logaddexp2(x, y)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_root_float_power_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.rand(3, 4) + 0.5)
    y = np.asarray(rng.randn(3, 4))
    out = paddle.float_power(paddle.to_tensor(x), paddle.to_tensor(y))
    expect = np.float_power(x, y)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-4, atol=1e-4)


def test_linalg_cross_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(4, 3))
    y = np.asarray(rng.randn(4, 3))
    out = paddle.linalg.cross(paddle.to_tensor(x), paddle.to_tensor(y))
    expect = np.cross(x, y)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)


def test_linalg_dot_golden():
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(5))
    y = np.asarray(rng.randn(5))
    out = paddle.linalg.dot(paddle.to_tensor(x), paddle.to_tensor(y))
    expect = np.dot(x, y)
    np.testing.assert_allclose(_np(out), expect, rtol=1e-05, atol=1e-05)
