"""``paddle_tpu_torch.autograd`` (``PyLayer``, ``jacobian`` / ``hessian`` /
``vjp`` / ``jvp``) and ``incubate.autograd`` against the JAX package on
the CPU, on the same numpy-made inputs (f32, rtol 1e-5 / atol 1e-6
unless a test says otherwise).

Each ``PyLayer`` here is written once over the package ``P`` and built
in both: keyword and non-tensor arguments, a backward that returns one
gradient per differentiable input or per tensor input, outputs marked
non-differentiable or integer (no cotangent for them), an output the
loss does not reach (a zero cotangent, also after
``set_materialize_grads(False)``, as the JAX tape fills it), double
backward, and a ``PyLayer`` inside ``jit.to_static``."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle

import paddle_tpu_torch as pt
from paddle_tpu_torch import device as port_device

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _cpu_default():
    before = port_device.DEFAULT_DEVICE
    port_device.DEFAULT_DEVICE = "cpu"
    yield
    port_device.DEFAULT_DEVICE = before


def _np(t):
    if t is None:
        return None
    return t.detach().numpy() if torch.is_tensor(t) else np.array(t._data)


def _inputs(P, *arrays, grad=True):
    if P is pt:
        return [torch.tensor(a, requires_grad=grad and a.dtype.kind == "f")
                for a in arrays]
    return [paddle.to_tensor(a, stop_gradient=not (grad and
                                                   a.dtype.kind == "f"))
            for a in arrays]


def _arrays(*shapes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def scaled_cube(P):
    """forward(ctx, x, k, power=3): k * x**3 with a Python number and a
    keyword; one gradient back."""
    class ScaledCube(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, k, power=3):
            ctx.save_for_backward(x)
            ctx.k, ctx.power = k, power
            return k * x * x * x

        @staticmethod
        def backward(ctx, dy):
            x, = ctx.saved_tensor()
            return ctx.power * ctx.k * x * x * dy
    return ScaledCube


def two_inputs_per_tensor(P):
    """Returns a gradient for every tensor input, the second of which
    records none (it is dropped)."""
    class Mul(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, y):
            ctx.save_for_backward(x, y)
            return x * y

        @staticmethod
        def backward(ctx, dz):
            x, y = ctx.saved_tensor()
            return dz * y, dz * x
    return Mul


def marked_and_integer(P):
    """Outputs (y, z, idx): z marked non-differentiable, idx integer; the
    backward receives y's cotangent alone and records its arity."""
    seen = []

    class Split(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            y, z = x * 2.0, x * 3.0
            ctx.mark_non_differentiable(z)
            return y, z, P.argmax(x, axis=-1)

        @staticmethod
        def backward(ctx, *cts):
            seen.append(len(cts))
            return cts[0] * 2.0
    return Split, seen


def unused_output(P):
    """(a, b) where the loss reads a only: b's cotangent arrives as zeros
    even with ``set_materialize_grads(False)``."""
    seen = []

    class Pair(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.set_materialize_grads(False)
            return x * 2.0, x * 5.0

        @staticmethod
        def backward(ctx, da, db):
            seen.append(db)
            return da * 2.0 + db * 5.0
    return Pair, seen


def _grad(P, outs, ins, create_graph=False):
    g = P.grad(outs, ins, create_graph=create_graph, allow_unused=True)
    return list(g)


def test_pylayer_keyword_and_number_arguments_match_jax():
    x, = _arrays((3, 4))
    res = {}
    for P in (paddle, pt):
        xt, = _inputs(P, x)
        y = scaled_cube(P).apply(xt, 1.5, power=3)
        gx, = _grad(P, [(y * y).sum()], [xt])
        res[P is pt] = (_np(y), _np(gx))
    for a, b in zip(res[True], res[False]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_pylayer_gradient_per_tensor_input_drops_the_frozen_one():
    x, y = _arrays((4,), (4,), seed=1)
    out = {}
    for P in (paddle, pt):
        xt, = _inputs(P, x)
        yt, = _inputs(P, y, grad=False)
        z = two_inputs_per_tensor(P).apply(xt, yt)
        out[P is pt] = _np(_grad(P, [z.sum()], [xt])[0])
    np.testing.assert_allclose(out[True], out[False], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out[True], y)


def test_pylayer_marked_and_integer_outputs_get_no_cotangent():
    x, = _arrays((2, 5), seed=2)
    for P in (paddle, pt):
        cls, seen = marked_and_integer(P)
        xt, = _inputs(P, x)
        y, z, idx = cls.apply(xt)
        assert (z.stop_gradient if P is paddle else not z.requires_grad)
        g, = _grad(P, [y.sum()], [xt])
        np.testing.assert_allclose(_np(g), np.full_like(x, 2.0))
        assert seen == [1]
        np.testing.assert_array_equal(_np(idx), x.argmax(-1))


def test_pylayer_unused_output_gets_zeros_as_in_jax():
    x, = _arrays((3,), seed=3)
    for P in (paddle, pt):
        cls, seen = unused_output(P)
        xt, = _inputs(P, x)
        a, _ = cls.apply(xt)
        g, = _grad(P, [a.sum()], [xt])
        np.testing.assert_allclose(_np(g), np.full_like(x, 2.0))
        assert len(seen) == 1 and not np.any(_np(seen[0]))


def test_pylayer_double_backward_matches_jax():
    """d/dx of (d cube / dx) . 1 with create_graph: the backward's own ops
    are recorded."""
    x, = _arrays((4,), seed=4)
    out = {}
    for P in (paddle, pt):
        xt, = _inputs(P, x)
        y = scaled_cube(P).apply(xt, 1.0)
        g, = _grad(P, [y.sum()], [xt], create_graph=True)
        gg, = _grad(P, [g.sum()], [xt])
        out[P is pt] = _np(gg)
    np.testing.assert_allclose(out[True], out[False], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out[True], 6 * x, rtol=RTOL, atol=ATOL)


def test_pylayer_without_gradients_is_its_forward_and_bad_arity_raises():
    x, = _arrays((3,), seed=5)
    xt, = _inputs(pt, x, grad=False)
    y = scaled_cube(pt).apply(xt, 1.0)
    assert y.grad_fn is None
    np.testing.assert_allclose(y.numpy(), x ** 3, rtol=1e-6)

    class Bad(pt.autograd.PyLayer):
        @staticmethod
        def forward(ctx, a, b):
            return a * b

        @staticmethod
        def backward(ctx, d):
            return d, d, d

    a, b = _inputs(pt, x, x)
    with pytest.raises(RuntimeError, match="returned 3 gradients"):
        Bad.apply(a, b).sum().backward()
    assert pt.autograd.py_layer.once_differentiable(lambda c, d: d) \
        .__class__ is staticmethod


def test_pylayer_stages_inside_to_static():
    """A step through a ``PyLayer`` staged on the CPU: no break, the
    staged run's losses equal the eager run's."""
    def run(staged):
        pt.seed(0)
        lin = pt.nn.Linear(4, 4)
        opt = pt.SGD(0.1, parameters=lin.parameters())
        cube = scaled_cube(pt)

        def step(x):
            loss = cube.apply(lin(x), 0.5).pow(2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        fn = pt.jit.to_static(step, capture=(lin, opt), full_graph=True) \
            if staged else step
        x = torch.from_numpy(_arrays((2, 4), seed=6)[0])
        losses = [float(fn(x)) for _ in range(3)]
        return losses, (fn.stats() if staged else None)

    eager, _ = run(False)
    staged, stats = run(True)
    assert stats["staged"] == 1 and stats["graph_breaks"] == 0
    np.testing.assert_allclose(staged, eager, rtol=1e-6)


# ------------------------------------------------------- the functionals
def _mlp_weights():
    return _arrays((3, 5), (5, 2), seed=7)


def _mlp(P, w1, w2):
    def f(x):
        return P.tanh(P.matmul(x, w1)) @ w2 if P is pt else \
            P.matmul(P.tanh(P.matmul(x, w1)), w2)
    return f


def _two(P, w1):
    def f(x, y):
        return P.tanh(P.matmul(x, w1)) * y
    return f


def _wrap(P, a):
    return torch.from_numpy(a) if P is pt else paddle.to_tensor(a)


@pytest.mark.parametrize("kind", ["jacobian", "hessian", "vjp", "vjp_v",
                                  "jvp", "jvp_v", "jacobian_two",
                                  "hessian_two", "vjp_two"])
def test_functional_derivatives_match_jax(kind):
    w1, w2 = _mlp_weights()
    x, v_out, v_in = _arrays((4, 3), (4, 2), (4, 3), seed=8)
    y, = _arrays((4, 5), seed=9)
    res = {}
    for P in (paddle, pt):
        A = P.autograd
        f = _mlp(P, _wrap(P, w1), _wrap(P, w2))
        xt = _wrap(P, x)
        if kind == "jacobian":
            out = A.jacobian(f, xt)
        elif kind == "hessian":
            out = A.hessian(lambda z: (f(z) * f(z)).sum(), xt)
        elif kind == "vjp":
            out = A.vjp(f, xt)
        elif kind == "vjp_v":
            out = A.vjp(f, xt, _wrap(P, v_out))
        elif kind == "jvp":
            out = A.jvp(f, xt)
        elif kind == "jvp_v":
            out = A.jvp(f, xt, _wrap(P, v_in))
        else:
            g = _two(P, _wrap(P, w1))
            pair = [xt, _wrap(P, y)]
            if kind == "jacobian_two":
                out = A.jacobian(g, pair)
            elif kind == "hessian_two":
                out = A.hessian(lambda a, b: (g(a, b) ** 2).sum(), pair)
            else:
                out = A.vjp(g, pair)
        res[P is pt] = out

    def flat(o):
        if isinstance(o, (tuple, list)):
            return [t for i in o for t in flat(i)]
        return [_np(o)]

    got, want = flat(res[True]), flat(res[False])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_create_graph_is_refused_as_in_jax():
    x = _arrays((3,), seed=10)[0]
    for P in (paddle, pt):
        xt = _wrap(P, x)
        for fn in (P.autograd.jacobian, P.autograd.hessian):
            with pytest.raises(NotImplementedError, match="create_graph"):
                fn(lambda z: (z * z).sum(), xt, create_graph=True)


def test_jvp_through_a_kernel_function_raises():
    """Forward mode has no rule through a kernel ``autograd.Function`` (as
    a JAX custom-VJP kernel has none): a clear error, not tangents from
    another rule."""
    x = torch.from_numpy(_arrays((2, 8), seed=11)[0])
    w = torch.ones(8)
    with pytest.raises(NotImplementedError, match="forward-mode"):
        pt.autograd.jvp(lambda z: pt.incubate.fused_rms_norm(z, w), x)
    # reverse mode through the same kernel function works
    _, g = pt.autograd.vjp(lambda z: pt.incubate.fused_rms_norm(z, w), x)
    assert g.shape == x.shape and torch.isfinite(g).all()


def test_incubate_autograd_matches_jax():
    w1, w2 = _mlp_weights()
    x, = _arrays((4, 3), seed=12)
    res = {}
    for P in (paddle, pt):
        IA = P.incubate.autograd
        f = _mlp(P, _wrap(P, w1), _wrap(P, w2))
        xt = _wrap(P, x)
        tangent = IA.forward_grad(f, xt)
        jac = IA.Jacobian(f, xt)
        xg = (torch.tensor(x, requires_grad=True) if P is pt else
              paddle.to_tensor(x, stop_gradient=False))
        g = IA.grad([f(xg).sum()], [xg])
        res[P is pt] = [_np(tangent), _np(jac), _np(g[0])]
        assert IA.prim_enabled() is True
        assert IA.enable_prim() is None and IA.disable_prim() is None
        assert IA.Hessian is IA.hessian
    for a, b in zip(res[True], res[False]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
