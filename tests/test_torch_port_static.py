"""The port's static mode (``static/program.py``, ``static/nn.py``,
``static/__init__.py``, ``enable_static`` / ``disable_static``) against
the JAX package's, on the CPU.

The cases of ``tests/test_static_program.py``, each in both packages:
the fit-a-line script run unmodified (both record it; the port's ``fc``
gets the JAX ``fc``'s weights, and the 60 losses and the test program's
predictions agree), the default program's recording, the ``[None, 3]``
shape, the missing feed, and ``save_inference_model`` /
``load_inference_model`` with the reference signature. Then the port's
own: a symbolic batch fed at several sizes and kept dynamic by the saved
program, a ``TransformerEncoder`` recorded with the flash and LayerNorm
kernels as their ops (``paddle_tpu_torch::flash_fwd`` /
``::layer_norm`` nodes) and equal to the same layers run eagerly, torch's
op names in the program (ROADMAP Queue 3), ``in_dynamic_mode`` and the
optimizer's parameters. Tolerances: f32 ``rtol 1e-4 / atol 1e-5``. The
autouse fixture puts both packages back in dygraph mode."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle

import paddle_tpu_torch as pt
from paddle_tpu_torch import device as port_device

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _dygraph_on_cpu():
    before = port_device.DEFAULT_DEVICE
    port_device.DEFAULT_DEVICE = "cpu"
    yield
    port_device.DEFAULT_DEVICE = before
    pt.disable_static()
    paddle.disable_static()


def _fit_a_line(pkg):
    """``tests/test_static_program.py:19``'s script, recorded."""
    pkg.enable_static()
    main = pkg.static.Program()
    startup = pkg.static.Program()
    with pkg.static.program_guard(main, startup):
        x = pkg.static.data(name="x", shape=[None, 13], dtype="float32")
        y = pkg.static.data(name="y", shape=[None, 1], dtype="float32")
        pred = pkg.static.nn.fc(x, size=1)
        cost = pkg.nn.functional.square_error_cost(input=pred, label=y)
        avg_loss = pkg.mean(cost)
        sgd = pkg.optimizer.SGD(learning_rate=0.05)
        sgd.minimize(avg_loss)
    return main, startup, pred, avg_loss


def test_fit_a_line_script_matches_jax():
    jmain, jstart, jpred, jloss = _fit_a_line(paddle)
    tmain, tstart, tpred, tloss = _fit_a_line(pt)
    assert not pt.in_dynamic_mode()
    by_shape = {tuple(p.shape): np.asarray(p._data)
                for p in jmain.all_parameters()}
    with torch.no_grad():
        for p in tmain.all_parameters():
            p.copy_(torch.from_numpy(np.array(by_shape[tuple(p.shape)])))
    jexe = paddle.static.Executor(paddle.CPUPlace())
    texe = pt.static.Executor(pt.CPUPlace())
    assert jexe.run(jstart) == texe.run(tstart) == []
    rng = np.random.RandomState(0)
    true_w = rng.randn(13, 1).astype("float32")
    X = rng.randn(64, 13).astype("float32")
    Y = X @ true_w
    tl, jl = [], []
    for _ in range(60):
        (a,) = texe.run(tmain, feed={"x": X, "y": Y}, fetch_list=[tloss])
        (b,) = jexe.run(jmain, feed={"x": X, "y": Y}, fetch_list=[jloss])
        tl.append(float(a))
        jl.append(float(b))
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    assert tl[-1] < 0.05 * tl[0]
    (tp,) = texe.run(tmain.clone(for_test=True), feed={"x": X, "y": Y},
                     fetch_list=[tpred])
    (jp,) = jexe.run(jmain.clone(for_test=True), feed={"x": X, "y": Y},
                     fetch_list=[jpred])
    assert tp.shape == (64, 1)
    np.testing.assert_allclose(tp, jp, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tp, Y, atol=0.6)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_default_main_program_records(pkg):
    p = paddle if pkg == "jax" else pt
    p.enable_static()
    prog = p.static.default_main_program()
    n0 = len(prog.vars)
    x = p.static.data(name="dx", shape=[None, 4], dtype="float32")
    z = x * 2.0 + 1.0
    assert isinstance(z, p.static.Variable)
    assert len(prog.vars) > n0
    (out,) = p.static.Executor().run(
        prog, feed={"dx": np.ones((2, 4), "float32")}, fetch_list=[z])
    np.testing.assert_allclose(out, np.full((2, 4), 3.0))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_static_shape_inference_keeps_batch_dim(pkg):
    p = paddle if pkg == "jax" else pt
    p.enable_static()
    with p.static.program_guard(p.static.Program()):
        x = p.static.data(name="sx", shape=[None, 8], dtype="float32")
        h = p.static.nn.fc(x, size=3)
        assert h.shape == [None, 3]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_executor_missing_feed_raises(pkg):
    p = paddle if pkg == "jax" else pt
    p.enable_static()
    with p.static.program_guard(p.static.Program()):
        x = p.static.data(name="mx", shape=[None, 2], dtype="float32")
        z = x + 1.0
        with pytest.raises(RuntimeError, match="not fed"):
            p.static.Executor().run(p.static.default_main_program(),
                                    feed={}, fetch_list=[z])
        with pytest.raises(KeyError):
            p.static.Executor().run(p.static.default_main_program(),
                                    feed={"nope": np.ones((1, 2))},
                                    fetch_list=[z])


def test_save_load_inference_model_reference_signature(tmp_path):
    """``save_inference_model(path, feed_vars, fetch_vars, exe)``: the
    loaded program gives the executor's fetch, and the JAX package's."""
    outs = {}
    X = np.random.RandomState(0).randn(1, 6).astype("float32")
    for pkg, p in (("jax", paddle), ("port", pt)):
        p.enable_static()
        main = p.static.Program()
        with p.static.program_guard(main):
            x = p.static.data(name="ix", shape=[1, 6], dtype="float32")
            out = p.static.nn.fc(x, size=2)
        if pkg == "port":   # the JAX fc's weights
            with torch.no_grad():
                for q in main.all_parameters():
                    q.copy_(torch.from_numpy(np.array(jw[tuple(q.shape)])))
        else:
            jw = {tuple(q.shape): np.asarray(q._data)
                  for q in main.all_parameters()}
        exe = p.static.Executor()
        path = str(tmp_path / pkg)
        p.static.save_inference_model(path, [x], [out], exe)
        (ref,) = exe.run(main, feed={"ix": X}, fetch_list=[out])
        p.disable_static()
        loaded = p.static.load_inference_model(path, exe)
        got = loaded(p.to_tensor(X))
        got = np.asarray(got.numpy() if pkg == "jax" else got.detach())
        np.testing.assert_allclose(got, ref, rtol=1e-5)
        outs[pkg] = got
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=RTOL,
                               atol=ATOL)


def test_symbolic_batch_runs_at_every_size_and_saves_dynamic(tmp_path):
    """The program's ``None`` batch is symbolic: ``fc``'s reshapes are
    recorded as expressions, so any batch runs, and the saved program
    keeps the batch dynamic (JAX saves batch 1)."""
    pt.enable_static()
    main = pt.static.Program()
    with pt.static.program_guard(main):
        x = pt.static.data(name="x", shape=[None, 3, 4], dtype="float32")
        h = pt.static.nn.fc(x, size=5, num_flatten_dims=2,
                            activation="relu")
        assert h.shape == [None, 3, 5]
    exe = pt.static.Executor()
    rng = np.random.RandomState(1)
    lin = [q for q in main.all_parameters() if q.dim() == 2][0]
    bias = [q for q in main.all_parameters() if q.dim() == 1][0]
    for b in (1, 2, 7):
        X = rng.randn(b, 3, 4).astype("float32")
        (got,) = exe.run(main, feed={"x": X}, fetch_list=[h])
        want = torch.relu(torch.from_numpy(X) @ lin + bias)
        np.testing.assert_allclose(got, want.detach().numpy(), rtol=RTOL,
                                   atol=ATOL)
    path = str(tmp_path / "dyn")
    pt.static.save_inference_model(path, [x], [h], exe)
    pt.disable_static()
    loaded = pt.static.load_inference_model(path)
    X = rng.randn(5, 3, 4).astype("float32")
    (want,) = exe.run(main, feed={"x": X}, fetch_list=[h])
    np.testing.assert_allclose(loaded(X).numpy(), want, rtol=RTOL,
                               atol=ATOL)


def test_encoder_program_holds_the_kernel_ops_and_matches_eager():
    """A ``TransformerEncoder`` recorded on a ``[None, 16, 32]`` Variable:
    its attention and norms are the ``flash_fwd`` and ``layer_norm`` ops
    (which run the kernels on the card), the other nodes torch's own
    functions; the program equals the layers run eagerly."""
    pt.enable_static()
    main = pt.static.Program()
    with pt.static.program_guard(main):
        h = pt.static.data(name="h", shape=[None, 16, 32], dtype="float32")
        layer = pt.nn.TransformerEncoderLayer(32, 2, 64, dropout=0.0)
        enc = pt.nn.TransformerEncoder(layer, 2)
        enc.eval()
        out = enc(h)
    names = [getattr(n.func, "__name__", str(n.func)) for n in main._nodes]
    assert names.count("flash_fwd") == 2
    assert names.count("layer_norm") == 4
    assert "softmax" not in names and "addmm" in names
    H = np.random.RandomState(2).randn(3, 16, 32).astype("float32")
    (got,) = pt.static.Executor().run(main, feed={"h": H}, fetch_list=[out])
    pt.disable_static()
    with torch.no_grad():
        want = enc(torch.from_numpy(H))
    np.testing.assert_allclose(got, want.numpy(), rtol=RTOL, atol=ATOL)


def test_modes_and_optimizer_parameters():
    assert pt.in_dynamic_mode()
    with pytest.raises(ValueError, match="parameters"):
        pt.SGD(learning_rate=0.1)
    pt.enable_static()
    assert not pt.in_dynamic_mode()
    opt = pt.SGD(learning_rate=0.1)
    assert opt._parameter_list == []
    pt.disable_static()
    assert pt.in_dynamic_mode()


@pytest.mark.parametrize("op", ["flash_fwd", "layer_norm", "rms_norm"])
def test_kernel_ops_differentiate_as_their_functions(op):
    """The ``torch.library`` ops a traced program holds carry their
    ``autograd.Function``'s backward (a recorded ``minimize`` replays
    through them): values and gradients equal the eager path's."""
    from paddle_tpu_torch.ops import kernels as K
    ops = torch.ops.paddle_tpu_torch
    rng = np.random.RandomState(3)
    if op == "flash_fwd":
        args = [torch.tensor(rng.randn(2, 8, 2, 16).astype("float32"),
                             requires_grad=True) for _ in range(3)]

        def eager(q, k, v):
            return K.flash_attention_bshd(q, k, v, causal=True)

        def traced(q, k, v):
            return ops.flash_fwd(q, k, v, 0.25, True)[0]
    else:
        args = [torch.tensor(rng.randn(*shape).astype("float32"),
                             requires_grad=True)
                for shape in ((4, 16), (16,), (16,))]
        fn = K.LayerNormFunction if op == "layer_norm" else K.RMSNormFunction
        lib = getattr(ops, op)

        def eager(x, w, b):
            return fn.apply(x, w, b, 1e-5)

        def traced(x, w, b):
            return lib(x, w, b, 1e-5)
    ct = torch.from_numpy(rng.randn(*eager(*args).shape).astype("float32"))
    got = torch.autograd.grad(traced(*args), args, ct)
    want = torch.autograd.grad(eager(*args), args, ct)
    torch.testing.assert_close(traced(*args), eager(*args), rtol=0, atol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
