"""The port's ``nn.Layer``, ``ParamAttr``, ``create_parameter`` and the
layers' JAX signatures against ``paddle_tpu`` on the CPU.

A small user model is written once and built in both packages (the same
class body over each package's ``nn``): its sublayer, parameter and
``state_dict`` names and their order, ``set_state_dict``'s missing and
unexpected keys and its shape check, the hooks and their removal,
``train`` / ``eval``, ``to(dtype)``, ``clear_gradients`` and
``create_parameter`` with each kind of ``attr`` are held against the JAX
package's, and its forward on carried weights within ``rtol 1e-5 / atol
1e-6`` (f32). A ``to_static`` step of a ``Layer`` model that gains a
sublayer mid-run re-walks its state and keeps JAX's losses (``rtol
1e-4 / atol 1e-5``). Each fault the ``Layer`` slice repaired has a test
here that failed before it: ``Linear(4, 8)`` uninitialised, no
``bias_attr`` / ``padding_idx`` / list ``normalized_shape`` / dropout
``axis`` and ``mode`` / ``MultiHeadAttention(weight_attr=)``, the
optimizers' per-parameter rate, ``pt.incubate``, and the models' initial
distributions.
"""
import inspect
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.jit import to_static as jax_to_static

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import device as port_device
from paddle_tpu_torch.core import random as port_random
from paddle_tpu_torch.jit import to_static

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
EXTRAS = {"device", "dtype", "generator"}


@pytest.fixture(autouse=True)
def _port_state():
    """Layers built without a device go to the CPU; the device and the
    framework RNG restored."""
    before = port_device.DEFAULT_DEVICE
    port_device.DEFAULT_DEVICE = "cpu"
    yield
    port_device.DEFAULT_DEVICE = before
    port_random._reset_state()


def _np(t):
    if isinstance(t, Tensor):
        return np.asarray(t._data, np.float32)
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _j(a):
    return Tensor(jnp.asarray(a))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _carry(jm, tm):
    arrays = {n: np.asarray(t._data) for n, t in jm.state_dict().items()}
    return pt.params_from_paddle_tpu(arrays, tm)


# ------------------------------------------------------ the user model
def _user_model(P):
    """A user's model over package ``P`` (``paddle_tpu`` or the port):
    nested layers in a ``LayerList``, a BatchNorm's buffers, a bias-free
    head, a parameter of its own and a persistable and a non-persistable
    buffer."""
    nn, init = P.nn, P.nn.initializer

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(8, 8)
            self.norm = nn.LayerNorm([8])

        def forward(self, x):
            return self.norm(x + self.fc(x))

    class User(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(11, 8, padding_idx=0)
            self.blocks = nn.LayerList([Block(), Block()])
            self.bn = nn.BatchNorm1D(8)
            self.head = nn.Linear(8, 3, bias_attr=False)
            self.scale = self.create_parameter(
                [3], default_initializer=init.Constant(1.5))
            self.register_buffer("count", P.zeros([1]))
            self.register_buffer("scratch", P.zeros([2]), persistable=False)

        def forward(self, ids):
            h = self.emb(ids)
            for block in self.blocks:
                h = block(h)
            return self.head(self.bn(h.mean(1))) * self.scale

    return User()


def _user_pair():
    paddle.seed(3)
    jm = _user_model(paddle)
    return jm, _carry(jm, _user_model(pt))


def _ids(seed=1):
    return np.random.RandomState(seed).randint(0, 11, (4, 5)).astype(
        np.int64)


def test_user_model_names_and_order_equal_jax():
    jm, tm = _user_pair()
    names = lambda it: [n for n, _ in it]  # noqa: E731
    assert names(tm.named_sublayers()) == names(jm.named_sublayers())
    assert names(tm.named_sublayers(prefix="m", include_self=True)) == \
        names(jm.named_sublayers(prefix="m", include_self=True))
    assert [type(m).__name__ for m in tm.sublayers(include_self=True)] == \
        [type(m).__name__ for m in jm.sublayers(include_self=True)]
    assert names(tm.named_parameters()) == names(jm.named_parameters())
    assert names(tm.named_parameters(include_sublayers=False)) == ["scale"]
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert "scratch" not in tm.state_dict()
    # the prefix is prepended as it is given (Paddle's rule; the JAX
    # package puts another "." after it)
    assert list(tm.state_dict(structured_name_prefix="net.")) == \
        ["net." + k for k in jm.state_dict()]
    assert list(tm.state_dict(include_sublayers=False)) == \
        list(jm.state_dict(include_sublayers=False)) == ["scale", "count"]
    assert isinstance(tm.parameters(), list)
    assert len(tm.parameters()) == len(jm.parameters()) == 13
    assert len(tm.buffers()) == len(jm.buffers()) == 4
    assert tm.full_name() == jm.full_name() == "user"
    assert tm.blocks[1].fc.full_name() == "linear"


def test_user_model_forward_equals_jax():
    jm, tm = _user_pair()
    ids = _ids()
    np.testing.assert_allclose(_np(tm(_t(ids))), _np(jm(_j(ids))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(tm.bn._mean), _np(jm.bn._mean),
                               rtol=RTOL, atol=ATOL)


def test_torch_calls_still_work():
    """torch's own callers: ``state_dict(prefix=, keep_vars=)``,
    ``named_parameters(recurse=, remove_duplicate=)``, ``train(False)``,
    ``load_state_dict``, a plain ``torch.nn.Module`` parent."""
    _, tm = _user_pair()
    sd = tm.state_dict(prefix="x.", keep_vars=True)
    assert sd["x.scale"] is tm.scale and "x.bn._mean" in sd
    assert [n for n, _ in tm.named_parameters(recurse=False)] == ["scale"]
    assert tm.train(False) is tm and not tm.blocks[0].fc.training
    outer = torch.nn.Sequential(tm)
    assert "0.blocks.1.norm.weight" in outer.state_dict()
    assert len(list(outer.parameters())) == 13
    fresh = _user_model(pt)
    fresh.load_state_dict(tm.state_dict())
    for a, b in zip(fresh.parameters(), tm.parameters()):
        assert torch.equal(a, b)


def test_set_state_dict_keys_and_shape_check_equal_jax():
    jm, tm = _user_pair()
    paddle.seed(9)
    src = {n: np.asarray(t._data) for n, t in
           _user_model(paddle).state_dict().items()}
    del src["head.weight"]
    src["bogus.weight"] = np.zeros(2, np.float32)
    jres = jm.set_state_dict({k: _j(v) for k, v in src.items()})
    ptrs = [p.data_ptr() for p in tm.parameters()]
    tres = tm.set_state_dict({k: _t(v) for k, v in src.items()})
    assert tres == tuple(jres) or list(tres) == list(jres)
    assert tres == (["head.weight"], ["bogus.weight"])
    assert [p.data_ptr() for p in tm.parameters()] == ptrs   # in place
    for name, p in tm.state_dict().items():
        if name in src:
            np.testing.assert_array_equal(_np(p), src[name], err_msg=name)
    np.testing.assert_allclose(_np(tm(_t(_ids()))), _np(jm(_j(_ids()))),
                               rtol=RTOL, atol=ATOL)
    bad = {"scale": np.zeros(4, np.float32)}
    with pytest.raises(ValueError, match="shape"):
        jm.set_state_dict({k: _j(v) for k, v in bad.items()})
    before = tm.emb.weight.detach().clone()
    with pytest.raises(ValueError, match="shape"):
        tm.set_state_dict({"emb.weight": torch.ones(11, 8), **{
            k: _t(v) for k, v in bad.items()}})
    assert torch.equal(tm.emb.weight, before)    # nothing copied
    assert tm.load_dict.__func__ is tm.set_state_dict.__func__


def test_hooks_and_their_removal_equal_jax():
    paddle.seed(4)
    jl = paddle.nn.Linear(3, 2)
    tl = _carry(jl, pt.nn.Linear(3, 2))
    x = np.random.RandomState(2).randn(2, 3).astype(np.float32)
    outs = {}
    for tag, layer, wrap in (("t", tl, _t), ("j", jl, _j)):
        seen = []
        pre = layer.register_forward_pre_hook(
            lambda m, inp: (inp[0] * 2,))
        post = layer.register_forward_post_hook(
            lambda m, inp, out: seen.append(inp[0].shape) or out + 1)
        hooked = layer(wrap(x))
        pre.remove()
        post.remove()
        plain = layer(wrap(x))
        outs[tag] = (_np(hooked), _np(plain), len(seen))
    np.testing.assert_allclose(outs["t"][0], outs["j"][0], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(outs["t"][1], outs["j"][1], rtol=RTOL,
                               atol=ATOL)
    assert outs["t"][2] == outs["j"][2] == 1
    np.testing.assert_allclose(
        outs["t"][0], _np(tl(_t(x * 2))) + 1, rtol=RTOL, atol=ATOL)


def test_train_eval_to_dtype_and_clear_gradients_equal_jax():
    jm, tm = _user_pair()
    for m in (jm, tm):
        m.eval()
        assert not any(s.training for s in m.sublayers(include_self=True))
        m.train()
        assert all(s.training for s in m.sublayers(include_self=True))
    loss = tm(_t(_ids())).sum()
    loss.backward()
    assert tm.head.weight.grad is not None
    tm.clear_gradients()
    assert all(p.grad is None for p in tm.parameters())
    jm.to(dtype="float16")
    tm.to(dtype="float16")
    assert [str(p.dtype).split(".")[-1] for p in tm.parameters()] == \
        ["float16"] * 13
    assert {str(np.dtype(p._data.dtype)) for p in jm.parameters()} == \
        {"float16"}
    assert tm.blocks[0].fc._dtype == torch.float16
    assert tm.create_parameter([2]).dtype == torch.float16
    assert jm.create_parameter([2]).dtype == paddle.float16
    tm.astype("float32")
    tm.to(torch.float64)                       # torch's positional form
    tm.to("cpu")                               # and a device name
    assert tm.scale.dtype == torch.float64 and tm._dtype == torch.float64
    assert tm.bn._mean.dtype == torch.float64


def _attr_cases(P):
    I = P.nn.initializer
    reg = P.regularizer.L2Decay(0.1)
    return {
        "none": dict(attr=None),
        "false": dict(attr=False),
        "param_attr": dict(attr=P.ParamAttr(
            name="w_full", initializer=I.Constant(0.5), learning_rate=2.0,
            regularizer=reg, trainable=False, need_clip=False)),
        "name": dict(attr="w_named"),
        "initializer": dict(attr=I.Constant(0.25)),
        "bias": dict(attr=None, is_bias=True),
        "default": dict(attr=None, default_initializer=I.Constant(3.0)),
        "float64": dict(attr=P.ParamAttr(initializer=I.Constant(1.0)),
                        dtype="float64"),
    }


@pytest.mark.parametrize("case", sorted(_attr_cases(paddle)))
def test_create_parameter_with_each_kind_of_attr(case):
    paddle.seed(0)
    jp = paddle.nn.Layer().create_parameter([6, 4],
                                            **_attr_cases(paddle)[case])
    tp = pt.nn.Layer().create_parameter([6, 4], **_attr_cases(pt)[case])
    if jp is None:
        assert tp is None
        return
    assert isinstance(tp, pt.Parameter)
    assert isinstance(tp, torch.nn.Parameter)
    assert tp.device.type == "cpu" and tuple(tp.shape) == (6, 4)
    assert str(tp.dtype).split(".")[-1] == str(np.dtype(jp._data.dtype))
    assert tp.trainable == jp.trainable == tp.requires_grad
    assert tp.optimize_attr == jp.optimize_attr
    assert tp.need_clip == jp.need_clip
    assert type(tp.regularizer).__name__ == type(jp.regularizer).__name__
    if case in ("param_attr", "name"):
        assert tp.name == jp.name
    else:
        assert tp.name.startswith("generated_tensor_")
    if case in ("none", "name"):    # XavierUniform over fans (6, 4)
        limit = np.sqrt(6.0 / 10)
        assert np.abs(_np(tp)).max() <= limit and _np(tp).std() > 0.1
    else:
        np.testing.assert_array_equal(_np(tp), _np(jp))


def test_free_create_parameter_and_top_level_names():
    p = pt.create_parameter([3, 2], "float32", attr=pt.ParamAttr(
        initializer=pt.nn.initializer.Constant(2.0), learning_rate=0.5))
    jp = paddle.create_parameter([3, 2], "float32", attr=paddle.ParamAttr(
        initializer=paddle.nn.initializer.Constant(2.0), learning_rate=0.5))
    np.testing.assert_array_equal(_np(p), _np(jp))
    assert p.optimize_attr == jp.optimize_attr == {"learning_rate": 0.5}
    for name in ("ParamAttr", "create_parameter", "Parameter", "LazyGuard",
                 "incubate", "batch", "check_shape"):
        assert hasattr(pt, name) and hasattr(paddle, name), name
    with pt.LazyGuard():
        lazy = pt.nn.Linear(2, 2)
    assert lazy.weight.shape == (2, 2)
    reader = pt.batch(lambda: iter(range(5)), 2)
    assert list(reader()) == list(paddle.batch(lambda: iter(range(5)), 2)())
    pt.check_shape([2, -1])
    with pytest.raises(ValueError):
        pt.check_shape([2, -3])
    assert pt.nn.Layer is pt.nn.layer.Layer
    assert issubclass(pt.nn.Linear, torch.nn.Module)


def test_parameter_stays_a_plain_tensor_to_torch(tmp_path):
    p = pt.Parameter(torch.ones(2, 3), name="w")
    p.optimize_attr["learning_rate"] = 3.0
    assert type(p * 2) is torch.Tensor and type(p.detach()) is torch.Tensor
    torch.save({"w": p}, tmp_path / "p.pt")
    back = torch.load(tmp_path / "p.pt", weights_only=True)["w"]
    assert torch.equal(back, p) and back.optimize_attr["learning_rate"] == 3
    m = pt.nn.Linear(2, 2)
    torch.save(m.state_dict(), tmp_path / "m.pt")
    sd = torch.load(tmp_path / "m.pt", weights_only=True)
    assert all(type(v) is torch.Tensor for v in sd.values())
    p.trainable = False
    assert not p.requires_grad and not p.trainable


def test_deepcopy_keeps_param_attrs():
    """``TransformerEncoder`` deep-copies its first layer: every copy
    keeps the ``ParamAttr``'s rate, ``need_clip`` and ``trainable``."""
    attr = pt.ParamAttr(learning_rate=0.5, need_clip=False)
    layer = pt.nn.TransformerEncoderLayer(8, 2, 16, dropout=0.0,
                                          weight_attr=attr)
    enc = pt.nn.TransformerEncoder(layer, 3)
    ws = [m.linear1.weight for m in enc.layers]
    assert len({w.data_ptr() for w in ws}) == 3
    for w in ws:
        assert w.optimize_attr == {"learning_rate": 0.5}
        assert w.need_clip is False and isinstance(w, pt.Parameter)
    assert torch.equal(ws[0], ws[2])


# ----------------------------------------------------- signatures (JAX's)
def _shared(jmod, tmod):
    out = []
    for n in sorted(set(dir(jmod)) & set(dir(tmod))):
        j, t = getattr(jmod, n), getattr(tmod, n)
        if n.startswith("_") or inspect.ismodule(j) or not callable(j) \
                or not callable(t):
            continue
        out.append(n)
    return out


def _params(obj, drop_extras):
    ps = inspect.signature(obj).parameters.values()
    return [p.name for p in ps if not (
        drop_extras and p.kind is p.KEYWORD_ONLY and p.name in EXTRAS)]


_SIGNATURE_CASES = (
    [("nn", n) for n in _shared(paddle.nn, pt.nn)]
    + [("nn.functional", n) for n in _shared(paddle.nn.functional,
                                             pt.nn.functional)]
    + [("nn.initializer", n) for n in _shared(paddle.nn.initializer,
                                              pt.nn.initializer)])


@pytest.mark.parametrize("space,name", _SIGNATURE_CASES,
                         ids=[f"{s}.{n}" for s, n in _SIGNATURE_CASES])
def test_signature_equals_jax(space, name):
    """Every name both namespaces export takes JAX's parameters in JAX's
    order; the port's ``device`` / ``dtype`` / ``generator`` may follow,
    keyword-only."""
    jmod, tmod = paddle, pt
    for part in space.split("."):
        jmod, tmod = getattr(jmod, part), getattr(tmod, part)
    assert _params(getattr(tmod, name), True) == \
        _params(getattr(jmod, name), False)


def test_signature_cases_cover_the_slice():
    names = {n for _, n in _SIGNATURE_CASES}
    assert {"Layer", "Linear", "Embedding", "LayerNorm", "RMSNorm",
            "Dropout", "LayerList", "LayerDict", "ParameterList",
            "MultiHeadAttention", "linear", "embedding", "dropout",
            "XavierUniform", "TruncatedNormal"} <= names
    assert len(_SIGNATURE_CASES) >= 125


# --------------------------------------------- the faults, one test each
def test_linear_is_initialised_with_jax_defaults():
    """``Linear(4, 8)``: XavierUniform weights (limit sqrt(6 / 12)), zero
    biases, on the current device; the card when nothing else is asked,
    which raises without one."""
    pt.seed(0)
    lin = pt.nn.Linear(4, 8)
    w = _np(lin.weight)
    limit = np.sqrt(6.0 / 12)
    assert np.abs(w).max() <= limit and np.abs(w).max() > 0.5 * limit
    assert abs(w.std() - limit / np.sqrt(3)) < 0.15
    assert np.abs(_np(lin.bias)).max() == 0.0
    assert lin.weight.device.type == "cpu"
    port_device.DEFAULT_DEVICE = "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt.nn.Linear(4, 8)
        assert pt.nn.Linear(4, 8, device="cpu").weight.device.type == "cpu"


def test_bias_attr_false_equals_jax():
    paddle.seed(1)
    jl = paddle.nn.Linear(5, 3, bias_attr=False)
    tl = pt.nn.Linear(5, 3, bias_attr=False)
    assert tl.bias is None and jl.bias is None
    assert list(tl.state_dict()) == list(jl.state_dict()) == ["weight"]
    _carry(jl, tl)
    x = np.random.RandomState(0).randn(2, 5).astype(np.float32)
    np.testing.assert_allclose(_np(tl(_t(x))), _np(jl(_j(x))), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("padding_idx", [0, 3, -2])
def test_padding_idx_row_is_zero_and_gets_no_gradient(padding_idx):
    paddle.seed(2)
    je = paddle.nn.Embedding(7, 4, padding_idx=padding_idx)
    te = pt.nn.Embedding(7, 4, padding_idx=padding_idx)
    row = padding_idx % 7
    assert np.abs(_np(te.weight)[row]).max() == 0.0
    assert np.abs(_np(je.weight)[row]).max() == 0.0
    _carry(je, te)
    ids = np.array([[row, 1, 2], [row, row, 5]], np.int64)
    tout = te(_t(ids))
    jout = je(_j(ids))
    np.testing.assert_array_equal(_np(tout), _np(jout))
    (tout * _t(np.arange(24, dtype=np.float32).reshape(2, 3, 4))).sum() \
        .backward()
    gw = _np(te.weight.grad)
    assert np.abs(gw[row]).max() == 0.0 and np.abs(gw[1]).max() > 0
    jw = je.weight
    jg = paddle.grad((jout * _j(np.arange(24, dtype=np.float32).reshape(
        2, 3, 4))).sum(), [jw])[0]
    np.testing.assert_allclose(gw, _np(jg), rtol=RTOL, atol=ATOL)


def test_layer_norm_over_a_list_of_axes_equals_jax():
    paddle.seed(5)
    jn = paddle.nn.LayerNorm([4, 8], epsilon=1e-5)
    tn = pt.nn.LayerNorm([4, 8], epsilon=1e-5)
    rng = np.random.RandomState(3)
    for m in (jn, tn):                       # non-trivial affine terms
        m.set_state_dict({"weight": rng.randn(4, 8).astype(np.float32),
                          "bias": rng.randn(4, 8).astype(np.float32)}
                         if m is jn else {k: _t(_np(v)) for k, v in
                                          jn.state_dict().items()})
    assert tuple(tn.weight.shape) == (4, 8)
    x = (rng.randn(3, 4, 8) * 3 + 1).astype(np.float32)
    xt = _t(x).requires_grad_(True)
    out = tn(xt)
    np.testing.assert_allclose(_np(out), _np(jn(_j(x))), rtol=1e-4,
                               atol=1e-5)
    ct = rng.randn(3, 4, 8).astype(np.float32)
    (out * _t(ct)).sum().backward()
    jx = paddle.to_tensor(x, stop_gradient=False)
    gx, gw = paddle.grad((jn(jx) * _j(ct)).sum(), [jx, jn.weight])
    np.testing.assert_allclose(_np(xt.grad), _np(gx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(tn.weight.grad), _np(gw), rtol=1e-4,
                               atol=1e-5)
    bare = pt.nn.LayerNorm(8, weight_attr=False, bias_attr=False)
    assert bare.weight is None and bare.bias is None
    assert list(bare.state_dict()) == []


def test_dropout_axis_and_mode_as_in_jax():
    x = torch.ones(6, 5)
    g = torch.Generator().manual_seed(0)
    # positionally, the third argument is ``axis`` as in JAX: a mask along
    # axis 0, shared along axis 1 (the port once read it as ``training``)
    y = TF.dropout(x, 0.5, 0, generator=g)
    assert not torch.equal(y, x)
    assert all(len(set(row.tolist())) == 1 for row in y)
    assert set(y.flatten().tolist()) <= {0.0, 2.0}
    y = TF.dropout(x, 0.5, [1], generator=g)
    assert all(len(set(col.tolist())) == 1 for col in y.T)
    y = TF.dropout(x, 0.5, mode="downscale_in_infer", generator=g)
    assert set(y.flatten().tolist()) <= {0.0, 1.0}
    assert torch.equal(TF.dropout(x, 0.3, training=False,
                                  mode="downscale_in_infer"), x * 0.7)
    assert TF.dropout(x, 0.3, training=False) is x
    j = _np(JF.dropout(_j(np.ones((6, 5), np.float32)), 0.3, training=False,
                       mode="downscale_in_infer"))
    np.testing.assert_allclose(j, _np(x * 0.7), rtol=1e-6)
    layer = pt.nn.Dropout(0.5, axis=1, mode="downscale_in_infer",
                          generator=torch.Generator().manual_seed(1))
    out = layer(x)
    assert all(len(set(col.tolist())) == 1 for col in out.T)
    assert torch.equal(layer.eval()(x), x * 0.5)
    with pytest.raises(ValueError):
        TF.dropout(x, 0.5, mode="scale")
    with pytest.raises(ValueError):
        TF.dropout(x, 0.5, axis=2)


def test_dropout_keeps_about_one_minus_p_per_axis_slice():
    x = torch.ones(4000, 3)
    g = torch.Generator().manual_seed(3)
    y = TF.dropout(x, 0.25, axis=0, generator=g)
    kept = (y[:, 0] != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.03
    assert torch.equal(y[:, 0], y[:, 2])


def test_multi_head_attention_takes_weight_attr():
    I_t, I_j = pt.nn.initializer, paddle.nn.initializer
    tm = pt.nn.MultiHeadAttention(8, 2, weight_attr=pt.ParamAttr(
        initializer=I_t.Constant(0.1)), bias_attr=pt.ParamAttr(
        initializer=I_t.Constant(0.05)))
    jm = paddle.nn.MultiHeadAttention(8, 2, weight_attr=paddle.ParamAttr(
        initializer=I_j.Constant(0.1)), bias_attr=paddle.ParamAttr(
        initializer=I_j.Constant(0.05)))
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    assert _np(tm.out_proj.weight)[0, 0] == pytest.approx(0.1)
    x = np.random.RandomState(4).randn(2, 3, 8).astype(np.float32)
    np.testing.assert_allclose(_np(tm(_t(x))), _np(jm(_j(x))), rtol=RTOL,
                               atol=ATOL)
    nob = pt.nn.MultiHeadAttention(8, 2, bias_attr=False)
    assert all(getattr(nob, p).bias is None
               for p in ("q_proj", "k_proj", "v_proj", "out_proj"))


def _rate_pair(P, lin_kw):
    """A two-Linear model whose first weight runs at 10x the rate, its
    first bias frozen and its second weight at half the rate."""
    nn = P.nn
    m = nn.Sequential(
        nn.Linear(4, 6, weight_attr=P.ParamAttr(learning_rate=10.0),
                  bias_attr=P.ParamAttr(trainable=False), **lin_kw),
        nn.Tanh(),
        nn.Linear(6, 2, weight_attr=P.ParamAttr(learning_rate=0.5),
                  **lin_kw))
    return m


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("opt", ["SGD", "AdamW", "Momentum"])
def test_per_parameter_rate_and_frozen_parameter_as_in_jax(opt, staged):
    paddle.seed(6)
    jm = _rate_pair(paddle, {})
    tm = _carry(jm, _rate_pair(pt, {}))
    frozen = tm[0].bias.detach().clone()
    kw = {"AdamW": dict(learning_rate=0.01, epsilon=1e-6,
                        weight_decay=0.01),
          "SGD": dict(learning_rate=0.05),
          "Momentum": dict(learning_rate=0.05, momentum=0.9)}[opt]
    jopt = getattr(paddle.optimizer, opt)(parameters=jm.parameters(), **kw)
    topt = getattr(pt.optimizer, opt)(parameters=tm.parameters(), **kw)
    rng = np.random.RandomState(7)
    X, Y = rng.randn(16, 4).astype(np.float32), rng.randn(16, 2).astype(
        np.float32)

    def jstep(xb, yb):
        loss = JF.mse_loss(jm(xb), yb)
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        return loss

    def tstep(xb, yb):
        loss = ((tm(xb) - yb) ** 2).mean()
        loss.backward()
        topt.step()
        topt.clear_grad()
        return loss

    if staged:
        jstep = jax_to_static(jstep, capture=(jm, jopt))
        tstep = to_static(tstep, capture=(tm, topt))
    jl = [float(_np(jstep(_j(X), _j(Y)))) for _ in range(4)]
    tl = [float(tstep(_t(X), _t(Y))) for _ in range(4)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-5)
    want = {n: _np(p) for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(_np(p), want[n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)
    assert torch.equal(tm[0].bias.detach(), frozen)
    if staged:
        assert tstep.stats()["graph_breaks"] == 0


def test_need_clip_false_passes_through_the_global_clip():
    lin = pt.nn.Linear(3, 2, bias_attr=pt.ParamAttr(need_clip=False))
    jl = paddle.nn.Linear(3, 2, bias_attr=paddle.ParamAttr(need_clip=False))
    _carry(jl, lin)
    x = np.random.RandomState(8).randn(5, 3).astype(np.float32) * 10
    topt = pt.SGD(0.1, parameters=lin.parameters(),
                  grad_clip=pt.nn.ClipGradByGlobalNorm(0.01))
    jopt = paddle.optimizer.SGD(0.1, parameters=jl.parameters(),
                                grad_clip=paddle.nn.ClipGradByGlobalNorm(
                                    0.01))
    (lin(_t(x)) ** 2).sum().backward()
    topt.step()
    jloss = (jl(_j(x)) ** 2).sum()
    jloss.backward()
    jopt.step()
    for n, p in jl.named_parameters():
        np.testing.assert_allclose(_np(getattr(lin, n)), _np(p), rtol=1e-4,
                                   atol=1e-5, err_msg=n)


def test_incubate_and_framework_seed_are_bound_at_import():
    code = ("import paddle_tpu_torch as pt; "
            "assert callable(pt.incubate.fused_rms_norm); "
            "assert pt.framework.seed is pt.seed; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ------------------------------------ a staged Layer that gains a layer
def _growing(P):
    class Net(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.body = P.nn.Sequential(P.nn.Linear(4, 4), P.nn.Tanh())

        def forward(self, x):
            return self.body(x)

    return Net()


def test_to_static_rewalks_a_layer_that_gains_a_sublayer():
    """Two staged SGD steps, then ``add_sublayer`` on the captured model
    (its parameters handed to the optimizer): the port's structural
    version moves, the state is walked again, the new layer trains, and
    the losses stay JAX's; ``__delattr__`` of a sublayer moves it too."""
    paddle.seed(12)
    jm = _growing(paddle)
    tm = _carry(jm, _growing(pt))
    jopt = paddle.optimizer.SGD(0.1, parameters=jm.parameters())
    topt = pt.SGD(0.1, parameters=tm.parameters())
    rng = np.random.RandomState(13)
    X, Y = rng.randn(8, 4).astype(np.float32), rng.randn(8, 4).astype(
        np.float32)

    def jstep(xb, yb):
        loss = JF.mse_loss(jm(xb), yb)
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        return loss

    def tstep(xb, yb):
        loss = ((tm(xb) - yb) ** 2).mean()
        loss.backward()
        topt.step()
        topt.clear_grad()
        return loss

    jstep = jax_to_static(jstep, capture=(jm, jopt))
    tstep = to_static(tstep, capture=(tm, topt))
    jl = [float(_np(jstep(_j(X), _j(Y)))) for _ in range(2)]
    tl = [float(tstep(_t(X), _t(Y))) for _ in range(2)]
    assert len(tstep._state_cached()[0]) == 2
    paddle.seed(14)
    jnew = paddle.nn.Linear(4, 4)
    tnew = _carry(jnew, pt.nn.Linear(4, 4))
    version = pt.nn.layer.layers.STRUCT_VERSION[0]
    jm.body.add_sublayer("2", jnew)
    assert tm.body.add_sublayer("2", tnew) is tnew
    assert pt.nn.layer.layers.STRUCT_VERSION[0] > version
    for opt, new in ((jopt, jnew), (topt, tnew)):
        for p in new.parameters():
            opt._parameter_list.append(p)
            opt._param_groups[0]["params"].append(p)
            if hasattr(opt, "_pid_to_param"):
                opt._pid_to_param[id(p)] = p
    w0 = tnew.weight.detach().clone()
    jl += [float(_np(jstep(_j(X), _j(Y)))) for _ in range(3)]
    tl += [float(tstep(_t(X), _t(Y))) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-5)
    assert len(tstep._state_cached()[0]) == 4
    assert not torch.equal(tnew.weight.detach(), w0)
    assert tstep.stats()["graph_breaks"] == 0
    version = pt.nn.layer.layers.STRUCT_VERSION[0]
    del tm.body[2]
    assert pt.nn.layer.layers.STRUCT_VERSION[0] > version
    assert len(tm.body) == 2


def test_containers_equal_jax():
    paddle.seed(15)
    for P in (paddle, pt):
        d = P.nn.LayerDict({"a": P.nn.Linear(2, 2), "b": P.nn.Tanh()})
        d["c"] = P.nn.ReLU()
        assert list(d.keys()) == ["a", "b", "c"] and "b" in d
        assert type(d.pop("b")).__name__ == "Tanh" and len(d) == 2
        ll = P.nn.LayerList([P.nn.Tanh()])
        ll.append(P.nn.ReLU()).insert(0, P.nn.Sigmoid())
        assert [type(m).__name__ for m in ll] == ["Sigmoid", "Tanh", "ReLU"]
        assert type(ll[-1]).__name__ == "ReLU" and len(ll[1:]) == 2
        del ll[0]
        assert [n for n, _ in ll.named_sublayers()] == ["0", "1"]
        plist = P.nn.ParameterList([P.create_parameter([2], "float32")])
        plist.append(P.create_parameter([3], "float32"))
        assert [n for n, _ in plist.named_parameters()] == ["0", "1"]
        seq = P.nn.Sequential(("first", P.nn.Tanh()), ("second",
                                                        P.nn.ReLU()))
        assert [n for n, _ in seq.named_sublayers()] == ["first", "second"]


# ----------------------------------------- the models' initial weights
def _model_pairs():
    """name -> () -> (JAX model, port model) built from seeds."""
    from paddle_tpu import models as jmodels
    return {
        "lenet": lambda: (jmodels.LeNet(), pt.LeNet(seed=1)),
        "gpt_tiny": lambda: (jmodels.GPTForCausalLM(jmodels.gpt_tiny()),
                             pt.GPTForCausalLM(pt.gpt_tiny(), seed=1)),
        "bert_tiny": lambda: (
            jmodels.BertForSequenceClassification(jmodels.bert_tiny()),
            pt.BertForSequenceClassification(pt.bert_tiny(), seed=1)),
        "resnet18": lambda: (jmodels.resnet18(num_classes=10),
                             pt.resnet18(num_classes=10, seed=1)),
        "seq2seq": lambda: (jmodels.Seq2SeqTransformer(16, 16, d_model=32),
                            pt.Seq2SeqTransformer(16, 16, d_model=32,
                                                  seed=1)),
    }


@pytest.mark.parametrize("name", sorted(_model_pairs()))
def test_models_start_from_jax_initial_distributions(name):
    """Every parameter of a fresh port model follows its JAX twin's
    initial distribution: constants exactly, random tensors by their
    bound and standard deviation (within 15% for 2048+ draws)."""
    paddle.seed(0)
    jm, tm = _model_pairs()[name]()
    want = {n: _np(p) for n, p in jm.named_parameters()}
    got = {n: _np(p) for n, p in tm.named_parameters()}
    assert got.keys() == want.keys()
    for n in want:
        w, g = want[n], got[n]
        assert w.shape == g.shape, n
        if w.std() == 0:
            np.testing.assert_array_equal(g, w, err_msg=n)
            continue
        assert g.std() > 0, n
        if w.size >= 2048:
            assert abs(g.std() / w.std() - 1) < 0.15, (n, g.std(), w.std())
            assert np.abs(g).max() <= 1.5 * np.abs(w).max(), n
