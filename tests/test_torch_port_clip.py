"""The port's gradient clips vs the JAX package's (``paddle_tpu/nn/
clip.py``) on the same numpy gradients, f32 and bf16, with one parameter
marked ``need_clip = False``. The norms are f32 sums taken in another
order in the two frameworks, so f32 results agree within ``rtol 1e-6``
and bf16 ones within one bf16 rounding (``rtol 8e-3``) of the JAX
values."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Parameter, Tensor

import paddle_tpu_torch as pt

SHAPES = [(6, 5), (7,), (3, 4, 2), (11,)]


def _grads(dtype, scale):
    rng = np.random.RandomState(3)
    gs = [(rng.randn(*s) * scale).astype(np.float32) for s in SHAPES]
    if dtype == "bfloat16":
        # bf16-representable values, so both packages start equal
        gs = [torch.from_numpy(g).bfloat16().float().numpy() for g in gs]
    return gs


def _pairs(gs, dtype):
    jpairs, tpairs = [], []
    for i, g in enumerate(gs):
        jp = Parameter(jnp.zeros(g.shape, jnp.float32))
        tp = torch.nn.Parameter(torch.zeros(g.shape))
        if i == 1:
            jp.need_clip = False
            tp.need_clip = False
        jpairs.append((jp, Tensor(jnp.asarray(g, dtype))))
        tpairs.append((tp, torch.from_numpy(g).to(getattr(torch, dtype))))
    return jpairs, tpairs


def _check(jout, tout, gs, dtype):
    tol = 1e-6 if dtype == "float32" else 8e-3
    for i, ((_, jg), (_, tg)) in enumerate(zip(jout, tout)):
        assert str(tg.dtype) == f"torch.{dtype}"
        np.testing.assert_allclose(tg.float().numpy(),
                                   np.asarray(jg._data, np.float32),
                                   rtol=tol, atol=1e-7, err_msg=str(i))
    # the need_clip=False gradient passes through as it was
    np.testing.assert_array_equal(tout[1][1].float().numpy(), gs[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", ["value", "norm", "global_norm",
                                  "global_norm_unclipped"])
def test_clip_matches_jax(clip, dtype):
    gs = _grads(dtype, 1.0)
    jpairs, tpairs = _pairs(gs, dtype)
    make = {"value": lambda m: m.ClipGradByValue(0.8, min=-0.5),
            "norm": lambda m: m.ClipGradByNorm(1.5),
            "global_norm": lambda m: m.ClipGradByGlobalNorm(2.0),
            "global_norm_unclipped": lambda m: m.ClipGradByGlobalNorm(1e3)}
    jout = make[clip](paddle.nn)(jpairs)
    tout = make[clip](pt.nn)(tpairs)
    _check(jout, tout, gs, dtype)
    if clip == "global_norm_unclipped":
        for (_, g), want in zip(tout, gs):
            np.testing.assert_array_equal(g.float().numpy(), want)


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_matches_jax(norm_type):
    gs = _grads("float32", 1.0)
    jps, tps = [], []
    for g in gs:
        jp = Parameter(jnp.zeros(g.shape, jnp.float32))
        jp._grad = jnp.asarray(g)
        tp = torch.nn.Parameter(torch.zeros(g.shape))
        tp.grad = torch.from_numpy(g.copy())
        jps.append(jp)
        tps.append(tp)
    jn = paddle.nn.clip_grad_norm_(jps, 1.0, norm_type=norm_type)
    tn = pt.nn.clip_grad_norm_(tps, 1.0, norm_type=norm_type)
    np.testing.assert_allclose(float(tn), float(np.asarray(jn._data)),
                               rtol=1e-6)
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jp._grad),
                                   rtol=1e-6, atol=1e-7)


def test_optimizer_clips_each_param_group_on_its_own():
    """The global norm is taken per param group (``optimizer.py:
    127-128``): one group's large gradients do not scale another's."""
    a, b = (torch.nn.Parameter(torch.zeros(4)) for _ in range(2))
    opt = pt.optimizer.Adam(learning_rate=0.1, parameters=[
        {"params": [a]}, {"params": [b]}],
        grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
    seen = []
    opt._apply = lambda items: seen.extend(items)
    a.grad = torch.full((4,), 10.0)        # norm 20: scaled to norm 1
    b.grad = torch.full((4,), 0.1)         # norm 0.2: left as it is
    opt.step()
    (pa, ga, _, _), (pb, gb, _, _) = seen
    assert pa is a and pb is b
    torch.testing.assert_close(ga, torch.full((4,), 0.5))
    torch.testing.assert_close(gb, torch.full((4,), 0.1))
    # the parameters' own gradients stay as they were
    assert torch.equal(a.grad, torch.full((4,), 10.0))
