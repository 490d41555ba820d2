"""The port's RMSNorm against the JAX package's Pallas kernel.

The same numpy inputs (seeded) go through ``paddle_tpu.ops.pallas.
rms_norm.rms_norm(interpret=True)`` — the Pallas kernel in interpret mode,
with its ``custom_vjp`` — and through ``paddle_tpu_torch``'s plain version,
which is what the ``rms_norm`` wrapper runs on a CPU tensor, its
``RMSNormFunction`` and ``incubate.fused_rms_norm``. Row counts are not a
multiple of the Pallas 256-row tile, so its padded grid is exercised.
Tolerance: f32 ``atol 1e-5`` (rsqrt and the row sums round differently);
bf16 one bf16 rounding of the output (both sides round one f32 result).
The Triton kernel itself runs only on the card:
``tests/test_torch_port_card.py``.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch.incubate as port_incubate
from paddle_tpu import incubate as jax_incubate
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.ops import kernels as K

jax_rms = importlib.import_module("paddle_tpu.ops.pallas.rms_norm")
rms_mod = importlib.import_module("paddle_tpu_torch.ops.kernels.rms_norm")

F32_ATOL = 1e-5
BF16_RTOL, BF16_ATOL = 2 ** -7, 1e-6       # one bf16 ulp of the output


def _inputs(rows, H, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(rows, H).astype(np.float32) * 2 + 0.5,
            (1 + 0.1 * rng.randn(H)).astype(np.float32),
            (0.1 * rng.randn(H)).astype(np.float32))


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_ATOL)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("rows", [300, 7])
def test_rms_norm_plain_matches_pallas_interpret(rows, with_bias, dtype):
    x, w, b = _inputs(rows, 96, seed=rows + with_bias)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_rms.rms_norm(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                            jnp.asarray(b, jdt) if with_bias else None,
                            eps=1e-6, interpret=True)
    assert want.dtype == jdt
    before = K.rms_norm.launches
    got = K.rms_norm(_torch(x, tdt), _torch(w, tdt),
                     _torch(b, tdt) if with_bias else None, 1e-6)
    # the CPU wrapper takes the plain version and launches nothing
    assert K.rms_norm.launches == before
    assert got.dtype == tdt and got.shape == x.shape
    _close(got.float().numpy(), want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("with_bias", [False, True])
def test_rms_norm_function_grads_match_jax_vjp(with_bias):
    """dx, dw (and db) of ``RMSNormFunction`` against ``jax.vjp`` of the
    Pallas kernel's ``custom_vjp``, over a [3, 5, 64] input."""
    rng = np.random.RandomState(4 + with_bias)
    x = rng.randn(3, 5, 64).astype(np.float32)
    w = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    b = (0.1 * rng.randn(64)).astype(np.float32)
    ct = rng.randn(3, 5, 64).astype(np.float32)
    jargs = [jnp.asarray(x), jnp.asarray(w)] + (
        [jnp.asarray(b)] if with_bias else [])
    out, vjp = jax.vjp(lambda *a: jax_rms.rms_norm(
        *a, eps=1e-5, interpret=True), *jargs)
    want = vjp(jnp.asarray(ct))
    targs = [_torch(a).requires_grad_(True) for a in
             ([x, w] + ([b] if with_bias else []))]
    got = K.RMSNormFunction.apply(targs[0], targs[1],
                                  targs[2] if with_bias else None, 1e-5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=F32_ATOL)
    grads = torch.autograd.grad(got, targs, _torch(ct))
    assert len(grads) == len(want)
    for g, wnt in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_incubate_fused_rms_norm_matches_jax_interpret(with_bias, dtype):
    x, w, b = _inputs(260, 64, seed=9)
    x = x.reshape(2, 130, 64)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jt = [paddle.to_tensor(np.asarray(jnp.asarray(a, jdt)))
          for a in (x, w, b)]
    want = jax_incubate.fused_rms_norm(
        jt[0], jt[1], jt[2] if with_bias else None, epsilon=1e-6,
        interpret=True)
    got = port_incubate.fused_rms_norm(
        _torch(x, tdt), _torch(w, tdt), _torch(b, tdt) if with_bias else None,
        epsilon=1e-6)
    alias = port_incubate.nn.functional.fused_rms_norm(
        _torch(x, tdt), _torch(w, tdt), _torch(b, tdt) if with_bias else None,
        epsilon=1e-6)
    assert torch.equal(alias, got)
    _close(got.float().numpy(), np.asarray(want._data.astype(jnp.float32)),
           dtype)


def test_incubate_fused_rms_norm_vs_jax_jnp_arm_in_bf16():
    """JAX's non-Pallas arm adds the bias after casting to x's type (two
    bf16 roundings); the port's kernel adds it in f32 (one): within two
    bf16 ulps of the output."""
    x, w, b = _inputs(33, 64, seed=11)
    jt = [paddle.to_tensor(np.asarray(jnp.asarray(a, jnp.bfloat16)))
          for a in (x, w, b)]
    want = jax_incubate.fused_rms_norm(jt[0], jt[1], jt[2], epsilon=1e-6,
                                       use_pallas=False)
    got = port_incubate.fused_rms_norm(
        *(_torch(a, torch.bfloat16) for a in (x, w, b)), epsilon=1e-6)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want._data.astype(jnp.float32)),
                               rtol=2 * BF16_RTOL, atol=2 ** -8)


def test_nn_rms_norm_matches_jax_layer():
    """``nn.RMSNorm`` (weight only, default epsilon 1e-6) and
    ``F.rms_norm`` against the JAX layer, and the layer's gradients."""
    x, w, _ = _inputs(10, 32, seed=12)
    jl = paddle.nn.RMSNorm(32)
    jl.weight._data = jnp.asarray(w)
    want = np.asarray(jl(paddle.to_tensor(x))._data)
    tl = pnn.RMSNorm(32, device="cpu", generator=None)
    assert tl.epsilon == 1e-6 and not hasattr(tl, "bias")
    with torch.no_grad():
        tl.weight.copy_(_torch(w))
    xt = _torch(x).requires_grad_(True)
    got = tl(xt)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=F32_ATOL)
    np.testing.assert_allclose(
        pnn.functional.rms_norm(_torch(x), tl.weight).detach().numpy(),
        want, atol=F32_ATOL)
    got.sum().backward()
    assert tl.weight.grad.shape == (32,) and xt.grad.shape == x.shape


def test_rms_norm_is_on_the_amp_black_list():
    """Under O1 the layer computes in f32, whatever its input's type, as
    the JAX package casts ``rms_norm``'s inputs."""
    from paddle_tpu_torch import auto_cast
    tl = pnn.RMSNorm(16, device="cpu", generator=torch.Generator())
    x = torch.randn(4, 16).bfloat16()
    with auto_cast(level="O1", dtype="bfloat16"):
        out = tl(x)
    assert out.dtype == torch.float32
    assert tl(x).dtype == torch.bfloat16


def test_triton_route_raises_without_triton_for_rms_norm():
    try:
        import triton  # noqa: F401
        pytest.skip("triton is installed here")
    except ImportError:
        pass
    with pytest.raises(ImportError):
        rms_mod._triton_kernel()
