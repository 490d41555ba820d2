"""The port's core runtime modules against the JAX package on the CPU:
``framework.flags`` (``get_flags`` / ``set_flags``, ``FLAGS_*`` from the
environment, the flags with a torch counterpart), the ``device`` runtime
(``TPUPlace``, the memory counters, ``Stream`` / ``Event`` /
``stream_guard`` as the JAX CPU device gives them), ``amp.debugging``
(``check_numerics``, the tensor checker, operator statistics,
``compare_accuracy``, ``check_layer_numerics``) and ``utils`` with
``cpp_extension.custom_op``.

Each test that touches process-wide state leaves it as it found it: the
autouse fixture puts back both packages' flags, the op seam, the
default device, the ``unique_name`` counters and the custom-op
registries."""
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework import flags as jax_flags
from paddle_tpu.utils import cpp_extension as jax_cpp

import paddle_tpu_torch as pt
from paddle_tpu_torch import device as port_device
from paddle_tpu_torch.amp import debugging as dbg
from paddle_tpu_torch.core import op_hook
from paddle_tpu_torch.framework import flags as port_flags
from paddle_tpu_torch.utils import cpp_extension as port_cpp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reset_process_state():
    before_dev = port_device.DEFAULT_DEVICE
    jax_values = {n: f.value for n, f in jax_flags._registry.items()}
    ops = (set(port_cpp._REGISTRY), set(jax_cpp._REGISTRY))
    port_device.DEFAULT_DEVICE = "cpu"
    yield
    dbg.disable_tensor_checker()
    dbg.disable_operator_stats_collection()
    port_flags.reset_flags()
    paddle.set_flags(jax_values)
    port_device.DEFAULT_DEVICE = before_dev
    pt.utils.unique_name._counters = {}
    paddle.utils.unique_name._counters = {}
    for reg, keep in ((port_cpp._REGISTRY, ops[0]),
                      (jax_cpp._REGISTRY, ops[1])):
        for name in set(reg) - keep:
            del reg[name]
    assert not op_hook.installed()


# ------------------------------------------------------------------ flags
def test_flag_registry_names_and_defaults_equal_jax():
    names = sorted(jax_flags._registry)
    assert sorted(port_flags._registry) == names
    assert pt.get_flags(names) == paddle.get_flags(names)
    assert pt.get_flags("FLAGS_benchmark") == {"FLAGS_benchmark": False}
    for P in (pt, paddle):
        with pytest.raises(ValueError, match="unknown flag"):
            P.set_flags({"FLAGS_not_a_flag": 1})
        with pytest.raises(ValueError, match="unknown flag"):
            P.get_flags(["FLAGS_not_a_flag"])
        P.set_flags({"FLAGS_benchmark": True})
        assert P.get_flags("FLAGS_benchmark")["FLAGS_benchmark"] is True


def test_flags_with_a_torch_counterpart_act_on_it():
    pt.set_flags({"FLAGS_default_dtype": "float64"})
    assert pt.get_default_dtype() == torch.float64
    pt.set_flags({"FLAGS_default_dtype": "float32"})
    assert pt.get_default_dtype() == torch.float32
    pt.set_flags({"FLAGS_cudnn_deterministic": True})
    assert torch.backends.cudnn.deterministic is True
    pt.set_flags({"FLAGS_cudnn_deterministic": False})
    assert torch.backends.cudnn.deterministic is False
    with pytest.raises(ValueError, match=">= 1"):
        pt.set_flags({"FLAGS_check_nan_inf_window": 0})


def test_flags_are_read_from_the_environment_at_import():
    env = dict(os.environ, FLAGS_benchmark="1",
               FLAGS_check_nan_inf_window="3",
               FLAGS_fraction_of_gpu_memory_to_use="0.5",
               PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c",
         "import paddle_tpu_torch as pt; print(pt.get_flags(["
         "'FLAGS_benchmark', 'FLAGS_check_nan_inf_window', "
         "'FLAGS_fraction_of_gpu_memory_to_use']))"],
        env=env, capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == (
        "{'FLAGS_benchmark': True, 'FLAGS_check_nan_inf_window': 3, "
        "'FLAGS_fraction_of_gpu_memory_to_use': 0.5}")


def test_check_nan_inf_flag_raises_at_the_op_and_by_window():
    """Window 1 raises at the op, as JAX's; window 4 reads the flags once 4
    results wait, so the error surfaces at the 4th op or at a flush; the
    seam is installed only while the flag is on."""
    assert not op_hook.installed()
    pt.set_flags({"FLAGS_check_nan_inf": True})
    assert op_hook.installed()
    x = torch.tensor([1.0, -1.0])
    torch.exp(x)
    with pytest.raises(FloatingPointError, match="'log'"):
        torch.log(x)
    paddle.set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError):
            paddle.log(paddle.to_tensor([1.0, -1.0]))
    finally:
        paddle.set_flags({"FLAGS_check_nan_inf": False})
    pt.set_flags({"FLAGS_check_nan_inf_window": 4})
    bad = torch.log(x)                # queued, not read yet
    assert torch.isnan(bad).any()
    with pytest.raises(FloatingPointError, match="'log'"):
        for _ in range(3):
            torch.exp(x)
    torch.log(x)
    with pytest.raises(FloatingPointError):
        op_hook.flush_nan_checks()
    pt.set_flags({"FLAGS_check_nan_inf": False})
    assert not op_hook.installed()
    torch.log(x)                      # off: no check


def test_flash_flag_leaves_cpu_tensors_on_their_plain_chain():
    """``FLAGS_use_flash_attention=False`` refuses attention on a CUDA
    tensor (the card test); a CPU tensor takes its plain chain either
    way."""
    q = torch.randn(1, 8, 2, 16)
    on = pt.incubate.flash_attention(q, q, q, causal=True)[0]
    pt.set_flags({"FLAGS_use_flash_attention": False})
    off = pt.incubate.flash_attention(q, q, q, causal=True)[0]
    torch.testing.assert_close(on, off, rtol=0, atol=0)


# ----------------------------------------------------------------- device
def test_tpu_place_is_the_cuda_place():
    assert pt.TPUPlace is pt.CUDAPlace is pt.device.TPUPlace
    assert pt.TPUPlace(1) == pt.CUDAPlace(1)
    assert pt.TPUPlace().is_gpu_place()
    assert pt.TPUPlace(0).torch_device() == torch.device("cuda", 0)


def test_cpu_device_runtime_is_the_jax_cpu_devices():
    """On the CPU: ``memory_stats`` is ``{}`` and the counters 0 (JAX's CPU
    device gives the same), streams and events are no-ops."""
    D = pt.device
    jstats = paddle.device.memory_stats()
    assert D.memory_stats() == {} == jstats
    for name in ("memory_allocated", "max_memory_allocated",
                 "memory_reserved", "max_memory_reserved"):
        assert getattr(D, name)() == 0 == getattr(paddle.device, name)()
        assert getattr(D.cuda, name)() == 0
    assert D.get_all_devices() == [torch.device("cpu")]
    s = D.Stream()
    assert s.cuda_stream is None and s.device == torch.device("cpu")
    s.synchronize()
    s.wait_stream(D.current_stream())
    e = s.record_event()
    assert e.query() is True
    e.synchronize()
    with D.stream_guard(s):
        y = torch.ones(2) * 2
    D.synchronize()
    assert y.tolist() == [2.0, 2.0]
    D.cuda.empty_cache()
    assert D.cuda.get_device_properties() == {"name": "cpu",
                                              "platform": "cpu"}
    assert D.cuda.device_count() == torch.cuda.device_count()


# ------------------------------------------------------- amp.debugging
def _with_bad_values():
    return np.array([1.0, 0.0, np.nan, np.inf, -np.inf, 0.0, 2.0],
                    np.float32)


def test_check_numerics_counts_as_jax():
    a = _with_bad_values()
    J, T = paddle.amp.debugging, dbg
    got = T.check_numerics(torch.from_numpy(a),
                           debug_mode=T.DebugMode.CHECK_NAN_INF)
    want = J.check_numerics(paddle.to_tensor(a),
                            debug_mode=J.DebugMode.CHECK_NAN_INF)
    assert [int(t) for t in got] == [int(np.array(t._data)) for t in want] \
        == [1, 2, 2]
    assert all(t.dtype == torch.int64 for t in got)
    for mod, x in ((T, torch.from_numpy(a)), (J, paddle.to_tensor(a))):
        with pytest.raises(FloatingPointError, match="1 NaN, 2 Inf"):
            mod.check_numerics(x, op_type="op", var_name="v")
    ok = T.check_numerics(torch.ones(3))
    assert [int(t) for t in ok] == [0, 0, 0]


def test_tensor_checker_aborts_prints_and_filters(capsys):
    x = torch.tensor([1.0, -1.0])
    dbg.enable_tensor_checker(dbg.TensorCheckerConfig())
    assert op_hook.installed()
    torch.exp(x)
    with pytest.raises(FloatingPointError, match="op 'log'"):
        torch.log(x)
    dbg.enable_tensor_checker(dbg.TensorCheckerConfig(
        debug_mode=dbg.DebugMode.CHECK_NAN_INF))
    y = torch.log(x)                   # prints and carries on
    assert torch.isnan(y).any()
    assert "op 'log' produced NaN/Inf" in capsys.readouterr().out
    dbg.enable_tensor_checker(dbg.TensorCheckerConfig(
        checked_op_list=["matmul"]))
    torch.log(x)                       # not in the list
    with pytest.raises(FloatingPointError, match="op 'matmul'"):
        torch.matmul(torch.full((1, 2), float("inf")), torch.ones(2, 1))
    dbg.enable_tensor_checker(dbg.TensorCheckerConfig(
        skipped_op_list=["log"]))
    torch.log(x)                       # skipped
    with pytest.raises(FloatingPointError, match="op 'div'"):
        x / torch.zeros(2)
    dbg.enable_tensor_checker(dbg.TensorCheckerConfig())
    for _ in range(20):          # uninitialised memory is not checked
        torch.empty(4096)
        torch.empty_like(x)
    dbg.disable_tensor_checker()
    assert not op_hook.installed()
    torch.log(x)


def test_operator_statistics_count_each_op_by_dtype():
    a = torch.ones(3)
    b = torch.ones(3, dtype=torch.float64)
    with dbg.collect_operator_stats():
        for _ in range(3):
            a + a
        torch.matmul(b, b)
        torch.softmax(a, -1)
        stats = dict(dbg._op_stats)
    assert stats[("add", "torch.float32")] == 3
    assert stats[("matmul", "torch.float64")] == 1
    assert stats[("softmax", "torch.float32")] == 1
    assert not op_hook.installed()
    dbg.enable_operator_stats_collection()
    a * a
    assert dbg.disable_operator_stats_collection() == {
        ("mul", "torch.float32"): 1}


def test_checker_reads_nothing_while_staging():
    """A staged step under the checker: the staging call reads nothing
    back (a read there would break the graph), so it stages without a
    break; the eager call after it is checked again."""
    dbg.enable_tensor_checker(dbg.TensorCheckerConfig())
    pt.seed(0)
    lin = pt.nn.Linear(4, 2)
    opt = pt.SGD(0.1, parameters=lin.parameters())

    def step(x):
        loss = lin(x).pow(2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    staged = pt.jit.to_static(step, capture=(lin, opt), full_graph=True)
    x = torch.ones(3, 4)
    for _ in range(3):
        staged(x)
    st = staged.stats()
    assert st["staged"] == 1 and st["graph_breaks"] == 0
    with pytest.raises(FloatingPointError):
        torch.log(-x)


def test_compare_accuracy_writes_jaxs_table(tmp_path):
    rng = np.random.RandomState(0)
    a = {"w": rng.randn(3, 4).astype(np.float32),
         "b": rng.randn(4).astype(np.float32)}
    b = {"w": a["w"] + 1e-3, "b": a["b"] * 2, "extra": np.ones(2, np.float32)}
    rows = {}
    for name, P, wrap in (("port", pt, torch.from_numpy),
                          ("jax", paddle, paddle.to_tensor)):
        p1, p2 = tmp_path / f"{name}1", tmp_path / f"{name}2"
        P.save({k: wrap(v) for k, v in a.items()}, str(p1))
        P.save({k: wrap(v) for k, v in b.items()}, str(p2))
        out = tmp_path / f"{name}.csv"
        P.amp.debugging.compare_accuracy(str(p1), str(p2), str(out))
        rows[name] = out.read_text()
    assert rows["port"] == rows["jax"]
    assert rows["port"].splitlines()[0] == "tensor,max_abs_err,max_rel_err"


def test_check_layer_numerics_checks_inputs_and_outputs():
    class Net(pt.nn.Layer):
        @dbg.check_layer_numerics
        def forward(self, x):
            return torch.log(x)

    net = Net()
    assert torch.equal(net(torch.ones(2)), torch.zeros(2))
    with pytest.raises(FloatingPointError, match="input0"):
        net(torch.tensor([float("nan")]))
    with pytest.raises(FloatingPointError, match="output0"):
        net(torch.tensor([-1.0]))


# ------------------------------------------------------------------- utils
def test_run_check_unique_name_deprecated_try_import(capsys):
    assert pt.utils.run_check() is True
    assert "installed successfully" in capsys.readouterr().out
    assert pt.utils.run_check(verbose=False) is True
    for U in (pt.utils, paddle.utils):
        U.unique_name._counters = {}
    seq = [(pt.utils.unique_name.generate(k),
            paddle.utils.unique_name.generate(k))
           for k in ("fc", "fc", "tmp", "fc")]
    assert all(a == b for a, b in seq) and seq[-1][0] == "fc_2"
    with pt.utils.unique_name.guard():
        assert pt.utils.unique_name.generate("fc") == "fc_0"
    assert pt.utils.unique_name.generate("fc") == "fc_3"
    msgs = []
    for U in (pt.utils, paddle.utils):
        @U.deprecated(update_to="paddle.new", since="2.0", reason="moved")
        def old(v):
            return v + 1
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert old(1) == 2
        msgs.append(str(w[0].message))
        assert w[0].category is DeprecationWarning
    assert msgs[0] == msgs[1]
    assert pt.utils.try_import("math").sqrt(4.0) == 2.0
    with pytest.raises(ImportError, match="nope"):
        pt.utils.try_import("not_a_module_anywhere", "nope")


def _scale_sq(x, alpha=2.0):
    return alpha * x * x


def _scale_sq_vjp(ct, x, alpha=2.0, out=None):
    return 2 * alpha * x * ct


def _pair(x):
    return x * 2.0, x * x


def _pair_vjp(ct, x, out=None):
    return ct[0] * 2.0 + ct[1] * 2.0 * x


@pytest.mark.parametrize("with_vjp", [False, True])
def test_custom_op_matches_jax(with_vjp):
    """One function body over both packages' arrays (operators only): the
    output and gradient equal JAX's, by autograd through the function or
    by the user's ``vjp``; two outputs with a tuple cotangent."""
    x = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    res = {}
    for name, C, wrap in (("port", port_cpp, None), ("jax", jax_cpp, None)):
        tag = f"sq_{name}_{with_vjp}"
        op = C.custom_op(name=tag, vjp=_scale_sq_vjp if with_vjp else None)(
            _scale_sq)
        pair = C.custom_op(name=tag + "_pair", nout=2,
                           vjp=_pair_vjp if with_vjp else None)(_pair)
        if name == "port":
            xt = torch.tensor(x, requires_grad=True)
            y = op(xt, alpha=3.0)
            a, b = pair(xt)
            g, = torch.autograd.grad((y.sum() + a.sum() + b.sum()), [xt])
            res[name] = (y.detach().numpy(), g.numpy())
        else:
            xt = paddle.to_tensor(x, stop_gradient=False)
            y = op(xt, alpha=3.0)
            a, b = pair(xt)
            g, = paddle.grad([y.sum() + a.sum() + b.sum()], [xt])
            res[name] = (np.array(y._data), np.array(g._data))
        assert C.get_op(tag) is op and tag in C.registered_ops()
    for u, v in zip(res["port"], res["jax"]):
        np.testing.assert_allclose(u, v, rtol=1e-6, atol=1e-6)


def test_custom_op_golden_check_registry_and_refusals():
    op = port_cpp.custom_op(name="golden_sq", vjp=_scale_sq_vjp,
                            golden=lambda x: 2.0 * x * x)(_scale_sq)
    x = torch.randn(3, 4, dtype=torch.float64, requires_grad=True)
    op.check(x)
    bad = port_cpp.custom_op(name="bad_sq", vjp=lambda ct, x, out=None:
                             ct * x)(_scale_sq)
    with pytest.raises(AssertionError, match="grad"):
        bad.check(x, golden=lambda a: 2.0 * a * a)
    with pytest.raises(ValueError, match="already registered"):
        port_cpp.custom_op(name="golden_sq")(_scale_sq)
    again = port_cpp.custom_op(name="golden_sq", override=True)(_pair)
    assert port_cpp.get_op("golden_sq") is again
    with pytest.raises(KeyError, match="no custom op"):
        port_cpp.get_op("never_registered")
    with pytest.raises(NotImplementedError, match="torch.Tensor"):
        port_cpp.custom_op(name="bound", bind_method=True)(_scale_sq)
    assert "bound" not in port_cpp.registered_ops()
    with pytest.raises(TypeError, match="keyword"):
        op(x, alpha=torch.ones(1))
    with pytest.raises(ValueError, match="cotangents"):
        wrong = port_cpp.custom_op(
            name="wrong_arity", vjp=lambda ct, x, y, out=None: (ct,))(
                lambda x, y: x * y)
        wrong(x, x.detach().requires_grad_(True)).sum().backward()
    for fn in (pt.utils.cpp_extension.CppExtension,
               pt.utils.cpp_extension.CUDAExtension,
               pt.utils.cpp_extension.load):
        with pytest.raises(NotImplementedError, match="custom_op"):
            fn(name="ext", sources=["a.cc"])


def test_custom_op_stages_inside_to_static():
    op = port_cpp.custom_op(name="staged_sq", vjp=_scale_sq_vjp)(_scale_sq)
    pt.seed(0)
    lin = pt.nn.Linear(4, 4)
    opt = pt.SGD(0.1, parameters=lin.parameters())

    def step(x):
        loss = op(lin(x)).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    staged = pt.jit.to_static(step, capture=(lin, opt), full_graph=True)
    x = torch.ones(2, 4)
    losses = [float(staged(x)) for _ in range(3)]
    assert staged.stats()["staged"] == 1
    assert staged.stats()["graph_breaks"] == 0
    assert losses[2] < losses[0]
