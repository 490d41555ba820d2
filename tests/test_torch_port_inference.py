"""The port's inference predictor (``inference.py``) against the JAX
package's, on the CPU.

The cases of ``tests/test_inference_ptq.py:25`` (the handle flow),
``:38`` (a direct ``run`` and a missing model), ``:81`` (dynamic batching
under concurrent callers) and ``:122`` (``close``: queued requests fail,
later ones fail fast, the context manager), each in both packages on the
same weights (carried by ``params_from_paddle_tpu``) and inputs. Then the
port's own: a dynamic-batch export padded to its buckets, ``Config``'s
devices (``disable_gpu`` is the CPU; without a card the default raises,
it does not fall back) and the deliberate deviation that ``copy_to_cpu``
of a bfloat16 output is float32 numpy (ROADMAP Queue 3). The predictors
run on the CPU here (``Config.disable_gpu()``), as the JAX tests' run on
the CPU mesh. Tolerances: ``rtol 1e-4 / atol 1e-5`` (1e-5 relative where
the JAX test states it)."""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.inference import BatchingPredictor as JaxBatching
from paddle_tpu.inference import Predictor as JaxPredictor
from paddle_tpu.jit import InputSpec as JaxSpec
from paddle_tpu.jit import save_load as jax_save_load

import paddle_tpu_torch as pt
from paddle_tpu_torch import device as port_device
from paddle_tpu_torch.inference import (BatchingPredictor, Config,
                                        Predictor, create_predictor)
from paddle_tpu_torch.jit import InputSpec

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _port_device():
    before = port_device.DEFAULT_DEVICE
    port_device.DEFAULT_DEVICE = "cpu"
    yield
    port_device.DEFAULT_DEVICE = before


def _cpu(path):
    cfg = Config(path)
    cfg.disable_gpu()
    return cfg


def _export(tmp_path, spec=(2, 8)):
    """``_export`` of the JAX test in both packages -> (JAX net, port net,
    JAX path, port path)."""
    paddle.seed(0)
    jnet = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    tnet = pt.params_from_paddle_tpu(
        {n: np.asarray(v._data) for n, v in jnet.state_dict().items()},
        pt.nn.Sequential(pt.nn.Linear(8, 16), pt.nn.ReLU(),
                         pt.nn.Linear(16, 4)))
    jpath, tpath = str(tmp_path / "jmodel"), str(tmp_path / "tmodel")
    jax_save_load.save(jnet, jpath, input_spec=[JaxSpec([2, 8], "float32")])
    pt.jit.save(tnet, tpath, input_spec=[InputSpec(list(spec), "float32")])
    return jnet, tnet, jpath, tpath


def test_predictor_handle_flow(tmp_path):
    jnet, tnet, jpath, tpath = _export(tmp_path)
    x = np.random.RandomState(0).randn(2, 8).astype("float32")
    outs = []
    for pred in (paddle.inference.create_predictor(
            paddle.inference.Config(jpath)), create_predictor(_cpu(tpath))):
        h = pred.get_input_handle(pred.get_input_names()[0])
        h.copy_from_cpu(x)
        pred.run()
        outs.append(pred.get_output_handle(
            pred.get_output_names()[0]).copy_to_cpu())
    assert isinstance(outs[1], np.ndarray)
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(outs[1], tnet(torch.from_numpy(x)).detach()
                               .numpy(), rtol=1e-5)


def test_predictor_direct_run_and_missing_model(tmp_path):
    jnet, tnet, jpath, tpath = _export(tmp_path)
    x = np.random.RandomState(1).randn(2, 8).astype("float32")
    got = create_predictor(_cpu(tpath)).run([x])[0]
    want = paddle.inference.create_predictor(
        paddle.inference.Config(jpath)).run([x])[0]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert create_predictor(_cpu(tpath)).run([torch.from_numpy(x)])[0] \
        .shape == (2, 4)
    for p, cfg in ((paddle, paddle.inference.Config), (pt, _cpu)):
        with pytest.raises(FileNotFoundError):
            p.inference.create_predictor(cfg(str(tmp_path / "nope")))
    with pytest.raises(RuntimeError, match="inputs not set"):
        create_predictor(_cpu(tpath)).run()


def test_batching_predictor_dynamic_batching(tmp_path):
    """Six concurrent single-example requests, grouped, padded to the one
    bucket of the saved shape, each caller given its own row."""
    paddle.seed(0)
    jm = jnn.Sequential(jnn.Linear(4, 3), jnn.ReLU(), jnn.Linear(3, 2))
    tm = pt.params_from_paddle_tpu(
        {n: np.asarray(v._data) for n, v in jm.state_dict().items()},
        pt.nn.Sequential(pt.nn.Linear(4, 3), pt.nn.ReLU(),
                         pt.nn.Linear(3, 2)))
    paddle.jit.save(jm, str(tmp_path / "j"),
                    input_spec=[paddle.static.InputSpec([4, 4], "float32")])
    pt.jit.save(tm, str(tmp_path / "t"),
                input_spec=[pt.static.InputSpec([4, 4], "float32")])
    rng = np.random.RandomState(0)
    examples = [rng.randn(4).astype("float32") for _ in range(6)]
    results = {}
    for pkg, bp in (("jax", JaxBatching(JaxPredictor(str(tmp_path / "j")),
                                        max_batch_size=4, max_wait_ms=30.0,
                                        batch_buckets=[4])),
                    ("port", BatchingPredictor(
                        Predictor(_cpu(str(tmp_path / "t"))),
                        max_batch_size=4, max_wait_ms=30.0,
                        batch_buckets=[4]))):
        res = [None] * 6

        def call(i, bp=bp, res=res):
            res[i] = bp.predict(examples[i])

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        bp.close()
        results[pkg] = np.stack(res)
    want = tm(torch.from_numpy(np.stack(examples))).detach().numpy()
    np.testing.assert_allclose(results["port"], want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(results["port"], results["jax"], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_batching_predictor_close_lifecycle(tmp_path, pkg):
    _, _, jpath, tpath = _export(tmp_path)
    make = (lambda **kw: JaxBatching(JaxPredictor(jpath), **kw)) \
        if pkg == "jax" else \
        (lambda **kw: BatchingPredictor(Predictor(_cpu(tpath)), **kw))
    bp = make(max_batch_size=2, max_wait_ms=5.0, batch_buckets=[2])
    bp._stop = True
    bp._worker.join(timeout=5.0)
    assert not bp._worker.is_alive()
    errors = []

    def call():
        try:
            bp.predict(np.zeros(8, np.float32), timeout=30.0)
        except Exception as e:
            errors.append(e)

    th = threading.Thread(target=call)
    th.start()
    while bp._q.empty():
        pass
    bp.close()
    th.join(timeout=5.0)
    assert not th.is_alive()
    assert len(errors) == 1 and isinstance(errors[0], RuntimeError)
    with pytest.raises(RuntimeError):
        bp.predict(np.zeros(8, np.float32))
    bp.close()
    with make(max_batch_size=2, batch_buckets=[2]) as bp2:
        worker = bp2._worker
        assert bp2.predict(np.zeros(8, np.float32)).shape == (4,)
    assert not worker.is_alive()


def test_batching_predictor_pads_a_dynamic_export_to_its_buckets(tmp_path):
    _, tnet, _, tpath = _export(tmp_path, spec=(None, 8))
    pred = Predictor(_cpu(tpath))
    seen = []
    run = pred.run
    pred.run = lambda inputs=None: seen.append(len(inputs[0])) or run(inputs)
    rng = np.random.RandomState(4)
    examples = [rng.randn(8).astype("float32") for _ in range(5)]
    with BatchingPredictor(pred, max_batch_size=4, max_wait_ms=50.0,
                           batch_buckets=[1, 2, 4]) as bp:
        res = [None] * 5
        threads = [threading.Thread(
            target=lambda i=i: res.__setitem__(i, bp.predict(examples[i])))
            for i in range(5)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
    assert set(seen) <= {1, 2, 4}
    want = tnet(torch.from_numpy(np.stack(examples))).detach().numpy()
    np.testing.assert_allclose(np.stack(res), want, rtol=RTOL, atol=ATOL)


def test_config_devices_and_no_fallback(tmp_path, monkeypatch):
    cfg = Config(str(tmp_path / "m.pdmodel"))
    assert cfg.prog_file() == str(tmp_path / "m") + ".pdmodel"
    cfg.disable_gpu()
    assert cfg.device() == torch.device("cpu")
    cfg.enable_use_gpu(device_id=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        cfg.device()
    with pytest.raises(RuntimeError):
        Config(str(tmp_path / "m")).device()
    assert "gpu" in Config().summary()


def test_copy_to_cpu_of_bfloat16_is_float32(tmp_path):
    """Deviation (ROADMAP Queue 3): numpy has no bfloat16 without
    ``ml_dtypes``, which the card's machine lacks; the handle returns the
    bf16 output as float32 numpy (exactly its values)."""
    net = pt.nn.Sequential(pt.nn.Linear(8, 4)).to(torch.bfloat16)
    path = str(tmp_path / "bf16")
    pt.jit.save(net, path, input_spec=[InputSpec([None, 8], "bfloat16")])
    pred = create_predictor(_cpu(path))
    x = torch.randn(3, 8, dtype=torch.bfloat16)
    (out,) = pred.run([x])
    h = pred.get_output_handle("output_0")
    assert out.dtype == np.float32 and h.copy_to_cpu().dtype == np.float32
    with torch.no_grad():
        want = net(x).float().numpy()
    np.testing.assert_array_equal(out, want)
