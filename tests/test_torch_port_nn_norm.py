"""The port's normalisation functionals and layers, and ``nn.utils``,
against the JAX package's on the CPU: forward values, dtypes and input
(and weight) gradients from numpy-made inputs within ``rtol / atol
1e-5`` (f32). ``F.layer_norm`` runs the LayerNorm kernel's wrapper (its
plain version on a CPU tensor, launching nothing); under ``auto_cast`` O1
the norms on the black list compute in f32 from bf16 inputs, as in
JAX."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu.nn.utils as JU

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as TF
import paddle_tpu_torch.nn.utils as TU
from paddle_tpu_torch import device as port_device
from paddle_tpu_torch.ops import kernels as K

from torch_nn_parity import check, rand, to_np


@pytest.fixture(autouse=True)
def _port_device():
    before = port_device.DEFAULT_DEVICE
    port_device.DEFAULT_DEVICE = "cpu"
    yield
    port_device.DEFAULT_DEVICE = before


def _carry(jl, tl):
    return pt.params_from_paddle_tpu(
        {n: np.asarray(t._data) for n, t in jl.state_dict().items()}, tl)


@pytest.mark.parametrize("shape,affine,eps", [
    ([16], True, 1e-5), ([16], False, 1e-5), ([4, 16], True, 1e-12),
    (16, True, 1e-3)])
def test_functional_layer_norm_equals_jax(shape, affine, eps):
    """Over the trailing axes, with and without weight and bias; on a CPU
    tensor the kernel wrapper takes its plain version and launches
    nothing."""
    n = [shape] if isinstance(shape, int) else shape
    x = rand(1, 3, 5, *n, scale=2.0) + 1.0
    args = [x] + ([rand(2, *n) + 1.0, rand(3, *n)] if affine else [])
    before = K.layer_norm.launches
    check(lambda a, *wb: JF.layer_norm(a, shape, *wb, epsilon=eps),
          lambda a, *wb: TF.layer_norm(a, shape, *wb, epsilon=eps), args)
    assert K.layer_norm.launches == before


NORM_CASES = [
    ("group_norm", [(2, 6, 4, 5)], dict(num_groups=3), True),
    ("group_norm", [(2, 4, 7)], dict(num_groups=2, epsilon=1e-3), True),
    ("instance_norm", [(2, 3, 5, 4)], dict(), True),
    ("instance_norm", [(2, 3, 2, 3, 4)], dict(eps=1e-3), True),
    ("normalize", [(3, 5, 4)], dict(), False),
    ("normalize", [(3, 5, 4)], dict(p=1, axis=-1), False),
    ("normalize", [(3, 5, 4)], dict(p=3, axis=0), False),
    ("local_response_norm", [(2, 7, 3, 3)], dict(size=3), False),
    ("local_response_norm", [(2, 6, 5)], dict(size=4, alpha=1e-2, beta=0.5,
                                              k=2.0, data_format="NCL"),
     False),
]


@pytest.mark.parametrize("name,shapes,kw,affine", NORM_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(NORM_CASES)])
def test_norm_functional_equals_jax(name, shapes, kw, affine):
    x = rand(4, *shapes[0], scale=1.5) + 0.5
    if affine:
        c = shapes[0][1]
        w, b = rand(5, c) + 1.0, rand(6, c)
        check(lambda a, u, v: getattr(JF, name)(a, weight=u, bias=v, **kw),
              lambda a, u, v: getattr(TF, name)(a, weight=u, bias=v, **kw),
              [x, w, b])
    else:
        check(lambda a: getattr(JF, name)(a, **kw),
              lambda a: getattr(TF, name)(a, **kw), [x])


LAYER_CASES = [
    ("GroupNorm", (2, 6), (2, 6, 3, 4)),
    ("InstanceNorm1D", (4,), (2, 4, 7)),
    ("InstanceNorm2D", (4,), (2, 4, 3, 5)),
    ("InstanceNorm3D", (3,), (2, 3, 2, 3, 4)),
    ("LocalResponseNorm", (3,), (2, 5, 3, 3)),
]


@pytest.mark.parametrize("name,args,xs", LAYER_CASES,
                         ids=[c[0] for c in LAYER_CASES])
def test_norm_layer_equals_jax(name, args, xs):
    """Parameters carry by name; ``LocalResponseNorm`` is the JAX layer's
    own expression (alpha not divided by size)."""
    jl, tl = getattr(paddle.nn, name)(*args), getattr(pt.nn, name)(*args)
    _carry(jl, tl)
    check(jl, tl, [rand(7, *xs) + 0.3])


@pytest.mark.parametrize("name", ["BatchNorm3D", "SyncBatchNorm"])
def test_batch_norm_layers_train_and_eval_equal_jax(name):
    """Two training calls (running statistics updated by JAX's momentum
    rule), then one in eval, on carried weights."""
    shape = (2, 3, 4, 3, 2) if name == "BatchNorm3D" else (4, 3, 5, 2)
    jl, tl = getattr(paddle.nn, name)(3), getattr(pt.nn, name)(3)
    _carry(jl, tl)
    for i in range(2):
        x = rand(8 + i, *shape)
        np.testing.assert_allclose(
            tl(torch.from_numpy(x)).detach().numpy(),
            to_np(jl(paddle.to_tensor(x))), rtol=1e-5, atol=1e-5)
    for n in ("_mean", "_variance"):
        np.testing.assert_allclose(getattr(tl, n).numpy(),
                                   to_np(getattr(jl, n)), rtol=1e-6,
                                   atol=1e-6)
    jl.eval(), tl.eval()
    check(jl, tl, [rand(10, *shape)])


def test_convert_sync_batchnorm_keeps_parameters_and_buffers():
    model = pt.nn.Sequential(pt.nn.Conv2D(2, 3, 3), pt.nn.BatchNorm2D(3),
                             pt.nn.Sequential(pt.nn.BatchNorm1D(3)))
    w, mean = model[1].weight, model[1]._mean
    out = pt.nn.SyncBatchNorm.convert_sync_batchnorm(model)
    assert out is model and isinstance(model[1], pt.nn.SyncBatchNorm)
    assert isinstance(model[2][0], pt.nn.SyncBatchNorm)
    assert model[1].weight is w and model[1]._mean is mean
    assert model[2][0]._data_format == "NCL"


def test_spectral_norm_layer_refuses_as_in_jax():
    with pytest.raises(NotImplementedError):
        paddle.nn.SpectralNorm([3, 4])
    with pytest.raises(NotImplementedError):
        pt.nn.SpectralNorm([3, 4])


@pytest.mark.parametrize("name,args", [
    ("layer_norm", ([8],)), ("group_norm", (2,)), ("instance_norm", ()),
    ("normalize", ()), ("local_response_norm", ())])
def test_dtypes_under_o1_equal_jax(name, args):
    x = rand(11, 2, 4, 3, 8)
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        jy = getattr(JF, name)(paddle.to_tensor(x).astype("bfloat16"), *args)
    with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
        ty = getattr(TF, name)(torch.from_numpy(x).bfloat16(), *args)
    assert str(np.asarray(jy._data).dtype) == \
        str(ty.dtype).replace("torch.", "")


# ------------------------------------------------------------ nn.utils
def _linear_pair(seed, cls="Linear", args=(4, 3)):
    jl, tl = getattr(paddle.nn, cls)(*args), getattr(pt.nn, cls)(*args)
    _carry(jl, tl)
    return jl, tl


@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm_and_its_removal_equal_jax(dim):
    jl, tl = _linear_pair(0)
    JU.weight_norm(jl, dim=dim)
    TU.weight_norm(tl, dim=dim)
    assert [n for n, _ in jl.named_parameters()] == \
        [n for n, _ in tl.named_parameters()]
    np.testing.assert_allclose(tl.weight_g.detach().numpy(),
                               to_np(jl.weight_g), rtol=1e-6)
    x = rand(12, 5, 4)
    jy, ty = jl(paddle.to_tensor(x)), tl(torch.from_numpy(x))
    np.testing.assert_allclose(ty.detach().numpy(), to_np(jy), rtol=1e-5,
                               atol=1e-6)
    (jy * jy).sum().backward()
    (ty * ty).sum().backward()
    for n in ("weight_g", "weight_v"):
        np.testing.assert_allclose(getattr(tl, n).grad.numpy(),
                                   to_np(getattr(jl, n).grad), rtol=1e-5,
                                   atol=1e-5)
    JU.remove_weight_norm(jl)
    TU.remove_weight_norm(tl)
    assert sorted(n for n, _ in tl.named_parameters()) == ["bias", "weight"]
    np.testing.assert_allclose(tl.weight.detach().numpy(),
                               to_np(jl.weight), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("cls,args", [("Linear", (5, 3)),
                                      ("Conv1D", (2, 4, 3))])
def test_spectral_norm_equals_jax(cls, args):
    """Two calls (the power iteration's ``weight_u`` moves between them);
    the outputs, ``weight_u`` and the gradient of ``weight_orig``."""
    jl, tl = _linear_pair(1, cls, args)
    JU.spectral_norm(jl, n_power_iterations=2)
    TU.spectral_norm(tl, n_power_iterations=2)
    shape = (3, 5) if cls == "Linear" else (2, 2, 6)
    for i in range(2):
        x = rand(13 + i, *shape)
        jy, ty = jl(paddle.to_tensor(x)), tl(torch.from_numpy(x))
        np.testing.assert_allclose(ty.detach().numpy(), to_np(jy),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tl.weight_u.numpy(), to_np(jl.weight_u),
                               rtol=1e-5, atol=1e-6)
    jy.sum().backward()
    ty.sum().backward()
    np.testing.assert_allclose(tl.weight_orig.grad.numpy(),
                               to_np(jl.weight_orig.grad), rtol=1e-4,
                               atol=1e-5)


def test_parameter_vectors_and_grad_clips_equal_jax():
    jl, tl = _linear_pair(2, "Linear", (6, 4))
    jv = JU.parameters_to_vector(jl.parameters())
    tv = TU.parameters_to_vector(tl.parameters())
    np.testing.assert_allclose(tv.detach().numpy(), to_np(jv), rtol=0)
    new = rand(16, tv.numel())
    JU.vector_to_parameters(paddle.to_tensor(new), jl.parameters())
    with torch.no_grad():
        TU.vector_to_parameters(torch.from_numpy(new), tl.parameters())
    for (n, a), (_, b) in zip(jl.named_parameters(), tl.named_parameters()):
        np.testing.assert_array_equal(b.detach().numpy(), to_np(a))
    x = rand(17, 3, 6, scale=4.0)
    for clip in ("norm", "inf", "value"):
        for p in jl.parameters():
            p.clear_gradient()
        tl.clear_gradients()
        (jl(paddle.to_tensor(x)) ** 2).sum().backward()
        (tl(torch.from_numpy(x)) ** 2).sum().backward()
        if clip == "value":
            JU.clip_grad_value_(jl.parameters(), 0.5)
            TU.clip_grad_value_(tl.parameters(), 0.5)
        else:
            nt = 2.0 if clip == "norm" else float("inf")
            jn = JU.clip_grad_norm_(jl.parameters(), 1.0, nt)
            tn = TU.clip_grad_norm_(tl.parameters(), 1.0, nt)
            np.testing.assert_allclose(float(tn), float(to_np(jn)),
                                       rtol=1e-5)
        for a, b in zip(jl.parameters(), tl.parameters()):
            np.testing.assert_allclose(b.grad.numpy(), to_np(a.grad),
                                       rtol=1e-5, atol=1e-6)
    tl.weight.grad = torch.full_like(tl.weight, float("nan"))
    with pytest.raises(RuntimeError):
        TU.clip_grad_norm_(tl.parameters(), 1.0, error_if_nonfinite=True)
