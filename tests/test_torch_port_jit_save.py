"""The port's ``jit.save`` / ``jit.load`` against the JAX package's, on the
CPU.

The cases of ``tests/test_jit.py:154`` (the round trip and
``TranslatedLayer.train()`` raising) and ``:188`` (``InputSpec([None,
4])``: one export serves batches 1, 3 and 17), each in both packages on
the same weights (carried by ``params_from_paddle_tpu``) and the same
numpy inputs; ``Model.save(training=False)``; a ``bert_tiny`` classifier
exported on the CPU, which must hold one ``paddle_tpu_torch::flash_fwd``
op per layer and one ``::layer_norm`` op per LayerNorm, and no ``aten``
softmax or layer norm, and give the JAX model's logits; the file layout;
and the deliberate deviation: a JAX-written ``.pdmodel`` (StableHLO)
raises and names its format. Tolerances: f32 ``rtol 1e-4 / atol 1e-5``.
The bert export runs once, in a module fixture."""
import collections
import os
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.jit import InputSpec as JaxInputSpec
from paddle_tpu.models import BertForSequenceClassification as JaxCls
from paddle_tpu.models import bert_tiny as jax_bert_tiny

import paddle_tpu_torch as pt
from paddle_tpu_torch import device as port_device
from paddle_tpu_torch.jit import InputSpec

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _port_device():
    before = port_device.DEFAULT_DEVICE
    port_device.DEFAULT_DEVICE = "cpu"
    yield
    port_device.DEFAULT_DEVICE = before


def _np(t):
    return np.asarray(t._data, np.float32) if isinstance(t, Tensor) else \
        t.detach().float().numpy()


def _carry(jm, tm):
    arrays = {n: np.asarray(t._data) for n, t in jm.state_dict().items()}
    return pt.params_from_paddle_tpu(arrays, tm)


def _mlp_pair():
    paddle.seed(11)
    jm = jnn.Sequential(jnn.Linear(6, 16), jnn.ReLU(), jnn.Linear(16, 3))
    tm = _carry(jm, pt.nn.Sequential(pt.nn.Linear(6, 16), pt.nn.ReLU(),
                                     pt.nn.Linear(16, 3)))
    return jm, tm


def _ops(layer):
    """-> {op target: count} of the loaded program's graph."""
    return collections.Counter(
        str(n.target) for n in layer._exported.graph.nodes
        if n.op == "call_function")


def test_jit_save_load_roundtrip_matches_jax(tmp_path):
    jm, tm = _mlp_pair()
    jm.eval()
    tm.eval()
    x = np.random.RandomState(0).randn(4, 6).astype("float32")
    paddle.jit.save(jm, str(tmp_path / "j"),
                    input_spec=[JaxInputSpec([4, 6], "float32")])
    pt.jit.save(tm, str(tmp_path / "t"),
                input_spec=[InputSpec([4, 6], "float32")])
    jl, tl = paddle.jit.load(str(tmp_path / "j")), pt.jit.load(
        str(tmp_path / "t"))
    got = tl(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(jl(paddle.to_tensor(x))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(got), _np(tm(torch.from_numpy(x))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(tl(x)), _np(got), rtol=0, atol=0)
    for layer in (jl, tl):
        with pytest.raises(RuntimeError):
            layer.train()
    assert tl.eval() is tl and not tl.training


def test_jit_save_load_dynamic_batch_matches_jax(tmp_path):
    paddle.seed(0)
    jm = jnn.Sequential(jnn.Linear(4, 8), jnn.ReLU(), jnn.Linear(8, 2))
    tm = _carry(jm, pt.nn.Sequential(pt.nn.Linear(4, 8), pt.nn.ReLU(),
                                     pt.nn.Linear(8, 2)))
    jm.eval()
    paddle.jit.save(jm, str(tmp_path / "j"),
                    input_spec=[paddle.static.InputSpec([None, 4],
                                                        "float32")])
    pt.jit.save(tm, str(tmp_path / "t"),
                input_spec=[pt.static.InputSpec([None, 4], "float32")])
    jl, tl = paddle.jit.load(str(tmp_path / "j")), pt.jit.load(
        str(tmp_path / "t"))
    rng = np.random.RandomState(0)
    for b in (1, 3, 17):
        x = rng.randn(b, 4).astype("float32")
        got = tl(x)
        assert tuple(got.shape) == (b, 2)
        np.testing.assert_allclose(_np(got), _np(jl(paddle.to_tensor(x))),
                                   rtol=RTOL, atol=ATOL, err_msg=str(b))
    # training flags are put back after the export
    assert tm.training and all(m.training for m in tm.modules())


def test_save_requires_input_spec_in_both_packages(tmp_path):
    jm, tm = _mlp_pair()
    with pytest.raises(ValueError, match="input_spec"):
        paddle.jit.save(jm, str(tmp_path / "j"))
    with pytest.raises(ValueError, match="input_spec"):
        pt.jit.save(tm, str(tmp_path / "t"))


def test_files_keep_jax_names_and_carry_no_weights(tmp_path):
    _, tm = _mlp_pair()
    path = str(tmp_path / "m")
    pt.jit.save(tm, path, input_spec=[InputSpec([None, 6], "float32")])
    for ext in (".pdmodel", ".pdiparams", ".pdmeta"):
        assert os.path.exists(path + ext), ext
    assert zipfile.is_zipfile(path + ".pdmodel")
    state = pt.load(path + ".pdiparams", device="cpu")
    want = [p.detach() for p in tm.parameters()]
    assert len(state) == len(want)
    for a, b in zip(state, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert not a.requires_grad
    with zipfile.ZipFile(path + ".pdmodel") as z:
        stored = [(i.filename, i.file_size) for i in z.infolist()
                  if ("/data/weights/" in i.filename and not
                      i.filename.endswith("config.json"))
                  or ("/sample_inputs/" in i.filename and i.file_size)]
    assert not stored, stored


def test_staged_layer_exports_its_function(tmp_path):
    _, tm = _mlp_pair()
    tm.eval()
    pt.jit.to_static(tm)
    x = torch.from_numpy(np.random.RandomState(2).randn(3, 6).astype(
        "float32"))
    want = tm(x)
    pt.jit.save(tm, str(tmp_path / "s"),
                input_spec=[InputSpec([None, 6], "float32")])
    np.testing.assert_allclose(_np(pt.jit.load(str(tmp_path / "s"))(x)),
                               _np(want), rtol=RTOL, atol=ATOL)


def test_jax_pdmodel_raises_and_names_its_format(tmp_path):
    """Deviation (ROADMAP Queue 3): a JAX-written ``.pdmodel`` is
    serialized StableHLO, which the port cannot run."""
    jm, _ = _mlp_pair()
    path = str(tmp_path / "jax")
    paddle.jit.save(jm, path, input_spec=[JaxInputSpec([2, 6], "float32")])
    with pytest.raises(ValueError, match="StableHLO"):
        pt.jit.load(path)


def test_model_save_for_inference_matches_jax(tmp_path):
    """``Model.save(training=False)`` exports through ``jit.save`` with
    the model's ``inputs`` (``paddle_tpu/hapi/model.py:502-507``)."""
    jm, tm = _mlp_pair()
    jmodel = paddle.Model(jm, inputs=[JaxInputSpec([None, 6], "float32")])
    tmodel = pt.Model(tm, inputs=[InputSpec([None, 6], "float32")])
    jmodel.save(str(tmp_path / "j"), training=False)
    tmodel.save(str(tmp_path / "t"), training=False)
    x = np.random.RandomState(3).randn(5, 6).astype("float32")
    got = pt.jit.load(str(tmp_path / "t"))(x)
    want = paddle.jit.load(str(tmp_path / "j"))(paddle.to_tensor(x))
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------- bert_tiny
@pytest.fixture(scope="module")
def bert_export(tmp_path_factory):
    """``bert_tiny`` in both packages on carried weights, the port's
    exported on the CPU with a dynamic batch and loaded once."""
    before = port_device.DEFAULT_DEVICE
    port_device.DEFAULT_DEVICE = "cpu"
    try:
        paddle.seed(20)
        jm = JaxCls(jax_bert_tiny())
        jm.eval()
        tm = _carry(jm, pt.BertForSequenceClassification(
            pt.bert_tiny(), device="cpu", seed=None))
        tm.eval()
        path = str(tmp_path_factory.mktemp("bert") / "bert")
        pt.jit.save(tm, path, input_spec=[InputSpec([None, 16], "int64")])
        yield jm, tm, pt.jit.load(path)
    finally:
        port_device.DEFAULT_DEVICE = before


def test_bert_export_holds_one_kernel_op_per_kernel_call(bert_export):
    _, tm, loaded = bert_export
    ops = _ops(loaded)
    layers = tm.bert.config.num_layers
    assert ops["paddle_tpu_torch.flash_fwd.default"] == layers
    assert ops["paddle_tpu_torch.layer_norm.default"] == 2 * layers + 1
    plain = [k for k in ops if "softmax" in k or k.startswith(
        "aten.layer_norm") or k.startswith("aten.native_layer_norm")]
    assert not plain, plain


@pytest.mark.parametrize("batch", [1, 3])
def test_bert_export_matches_jax(bert_export, batch):
    jm, tm, loaded = bert_export
    ids = np.random.RandomState(batch).randint(0, 1024, (batch, 16))
    got = loaded(ids.astype("int64"))
    want = jm(Tensor(jnp.asarray(ids, jnp.int32)))
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(got), _np(tm(torch.from_numpy(ids))),
                               rtol=RTOL, atol=ATOL)


def test_flash_attention_bshd_exports_as_the_kernel_op(tmp_path):
    """``pt.flash_attention_bshd``, called directly, is one entry for
    eager and traced calls: exported on the CPU, a layer that calls it
    holds one ``flash_fwd`` op and no plain softmax chain, and the loaded
    program gives the eager call's values."""
    class Attn(pt.nn.Layer):
        def forward(self, q, k, v):
            return pt.flash_attention_bshd(q, k, v, causal=True)

    spec = [InputSpec([None, 8, 2, 16], "float32")] * 3
    pt.jit.save(Attn(), str(tmp_path / "a"), input_spec=spec)
    loaded = pt.jit.load(str(tmp_path / "a"))
    ops = _ops(loaded)
    assert ops["paddle_tpu_torch.flash_fwd.default"] == 1
    assert not [k for k in ops if "softmax" in k], ops
    rng = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rng.randn(3, 8, 2, 16).astype("float32"))
               for _ in range(3))
    np.testing.assert_allclose(_np(loaded(q, k, v)),
                               _np(pt.flash_attention_bshd(q, k, v)),
                               rtol=RTOL, atol=ATOL)


def test_program_moves_to_a_device_of_another_index():
    """``.pdmeta`` records the export device with its index, so a program
    exported on ``cuda:0`` and loaded on ``cuda:1`` has its device
    arguments rewritten; the same device moves nothing."""
    from paddle_tpu_torch.jit.save_load import _needs_move
    assert _needs_move("cuda:0", torch.device("cuda:1"))
    assert _needs_move("cpu", torch.device("cuda:0"))
    assert _needs_move("cuda:0", torch.device("cpu"))
    assert not _needs_move("cuda:1", torch.device("cuda:1"))
    assert not _needs_move("cpu", torch.device("cpu"))
