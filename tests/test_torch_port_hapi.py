"""The port's high-level API against ``paddle_tpu`` on the CPU: ``metric``,
``hapi`` (``Model`` with its callbacks, ``summary``, ``flops``),
training telemetry and ``save`` / ``load``.

Weights go from the ``paddle_tpu`` model to the port through
``params_from_paddle_tpu``; data are numpy arrays from a seed, read in
order (``shuffle=False``). ``Model.fit`` stages the train step with
``jit.to_static`` in both packages. Tolerances: f32 ``rtol 1e-4 / atol
1e-5`` (history, evaluation and final weights); the logits ``predict``
gives after training, whose weights agree to ``rtol 1e-4``, within ``rtol
1e-4 / atol 1e-4`` (they are of order 1); O1 bf16 the losses within
``rtol 1e-2``, the bf16 limit of ``tests/test_torch_port_train.py``.
BERT's AdamW takes ``epsilon`` 1e-6, as ``tests/test_torch_port_train.py``
explains: the key bias has an exactly zero gradient, whose f32 rounding
noise Adam's normalisation would turn into full steps of random sign.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.hapi.callbacks as jcb
import paddle_tpu.io as jio
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed import env as jax_dist_env
from paddle_tpu.models import BertForSequenceClassification as JaxCls
from paddle_tpu.models import LeNet as JaxLeNet
from paddle_tpu.models import bert_tiny as jax_bert_tiny
from paddle_tpu.models import resnet18 as jax_resnet18

import paddle_tpu_torch as pt
import paddle_tpu_torch.hapi.callbacks as tcb
import paddle_tpu_torch.io as tio
from paddle_tpu_torch import device as port_device
from paddle_tpu_torch.hapi.model import Model as PortModel
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability import telemetry as ttelemetry
from paddle_tpu_torch.observability import tracing as ttracing

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _reset_process_state(monkeypatch):
    """The process state these tests read, reset around each test: the
    port's metrics and tracing (``tests/conftest.py`` resets the JAX
    package's), its current device (the CPU here, for layers built
    without one), and the JAX package's parallel environment. A JAX test
    that ran ``init_parallel_env`` earlier on the same worker leaves it
    initialised over the 8 CPU devices, and ``paddle_tpu``'s ``Model``
    then wraps its network in ``DataParallel`` and shards every batch
    over them, which a last batch of 4 cannot take."""
    monkeypatch.setattr(jax_dist_env, "_initialized", False)
    monkeypatch.setattr(jax_dist_env, "_world_mesh", None)
    monkeypatch.setattr(port_device, "DEFAULT_DEVICE", "cpu")
    tmetrics._reset_state()
    ttracing._reset_state()
    yield
    tmetrics._reset_state()
    ttracing._reset_state()
    ttelemetry._active = None


def _np(t):
    if isinstance(t, Tensor):
        return np.asarray(t._data, np.float32)
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t)


def _carry(jm, tm):
    arrays = {n: np.asarray(t._data) for n, t in jm.state_dict().items()}
    return pt.params_from_paddle_tpu(arrays, tm)


def _ds(io, x, y):
    class DS(io.Dataset):
        def __getitem__(self, i):
            return x[i], y[i]

        def __len__(self):
            return len(x)

    return DS()


def _lenet_data(seed, n):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 1, 28, 28).astype(np.float32)
    y = (x.reshape(n, -1)[:, :10].argmax(1)).astype(np.int64)
    return x, y


def _bert_data(seed, n, vocab=1024, s=16):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (n, s)).astype(np.int64)
    return ids, (ids[:, 1] % 2).astype(np.int64)


def _lenet_models(seed, metrics=True):
    paddle.seed(seed)
    jm = JaxLeNet()
    tm = _carry(jm, pt.LeNet(device="cpu", seed=None))
    jmodel, tmodel = paddle.Model(jm), pt.Model(tm)
    jmodel.prepare(paddle.optimizer.Adam(1e-3, parameters=jm.parameters()),
                   paddle.nn.CrossEntropyLoss(),
                   paddle.metric.Accuracy(topk=(1, 5)) if metrics else None)
    tmodel.prepare(pt.Adam(1e-3, parameters=tm.parameters()),
                   pt.nn.CrossEntropyLoss(),
                   pt.metric.Accuracy(topk=(1, 5)) if metrics else None)
    return jmodel, tmodel


def _bert_models(seed, amp=None, steps=8):
    paddle.seed(seed)
    jm = JaxCls(jax_bert_tiny())
    tm = _carry(jm, pt.BertForSequenceClassification(
        pt.bert_tiny(), device="cpu", seed=None))

    def sched(lr):
        return lr.LinearWarmup(lr.PolynomialDecay(1e-3, steps - 2, 0.0), 2,
                               0.0, 1e-3)

    js, ts = sched(paddle.optimizer.lr), sched(pt.optimizer.lr)
    jmodel, tmodel = paddle.Model(jm), pt.Model(tm)
    jmodel.prepare(paddle.optimizer.AdamW(js, parameters=jm.parameters(),
                                          epsilon=1e-6, weight_decay=0.01),
                   paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy(),
                   amp_configs=amp)
    tmodel.prepare(pt.AdamW(ts, parameters=tm.parameters(), epsilon=1e-6,
                            weight_decay=0.01),
                   pt.nn.CrossEntropyLoss(), pt.metric.Accuracy(),
                   amp_configs=amp)
    return jmodel, tmodel, js, ts


def _assert_weights_close(jnet, tnet, rtol=RTOL, atol=ATOL):
    want = {n: np.asarray(t._data, np.float32)
            for n, t in jnet.state_dict().items()}
    got = pt.params_to_numpy(tnet)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=atol, err_msg=name)


def _assert_logs_close(got, want, rtol=RTOL, atol=ATOL):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   rtol=rtol, atol=atol, err_msg=k)


# --------------------------------------------------------------- metrics

def test_accuracy_topk_equals_jax_with_ties():
    rng = np.random.RandomState(0)
    pred = rng.randint(0, 3, (12, 6)).astype(np.float32)  # many ties
    label = rng.randint(0, 6, (12, 1)).astype(np.int64)
    jacc = paddle.metric.Accuracy(topk=(1, 2, 5))
    tacc = pt.metric.Accuracy(topk=(1, 2, 5))
    for lo, hi in ((0, 5), (5, 12)):
        jc = jacc.compute(Tensor(jnp.asarray(pred[lo:hi])),
                          Tensor(jnp.asarray(label[lo:hi])))
        tc = tacc.compute(torch.from_numpy(pred[lo:hi]),
                          torch.from_numpy(label[lo:hi]))
        np.testing.assert_array_equal(tc, jc)
        assert tacc.update(tc) == jacc.update(jc)
    assert tacc.accumulate() == jacc.accumulate()
    assert tacc.name() == jacc.name() == "acc"
    for k in (1, 3):
        assert float(pt.metric.accuracy(torch.from_numpy(pred),
                                        torch.from_numpy(label), k=k)) == \
            float(_np(paddle.metric.accuracy(Tensor(jnp.asarray(pred)),
                                             Tensor(jnp.asarray(label)),
                                             k=k)))
    tacc.reset()
    assert tacc.accumulate() == [0.0, 0.0, 0.0]


@pytest.mark.parametrize("name", ["Precision", "Recall", "Auc"])
def test_binary_metrics_equal_jax(name):
    rng = np.random.RandomState(1)
    preds = rng.rand(40).astype(np.float32)
    labels = rng.randint(0, 2, 40).astype(np.int64)
    if name == "Auc":
        preds = np.stack([1 - preds, preds], 1)
    jm, tm = getattr(paddle.metric, name)(), getattr(pt.metric, name)()
    for lo, hi in ((0, 17), (17, 40)):
        jm.update(Tensor(jnp.asarray(preds[lo:hi])),
                  Tensor(jnp.asarray(labels[lo:hi])))
        tm.update(torch.from_numpy(preds[lo:hi]),
                  torch.from_numpy(labels[lo:hi]))
    assert tm.accumulate() == pytest.approx(jm.accumulate(), rel=1e-12)
    assert tm.name() == jm.name()
    tm.reset()
    assert tm.accumulate() == 0.0


# ------------------------------------------------------- summary, flops

def _summary_pair(name):
    if name == "lenet":
        paddle.seed(0)
        return JaxLeNet(), pt.LeNet(device="cpu"), (1, 1, 28, 28), None
    if name == "resnet18":
        paddle.seed(0)
        return jax_resnet18(num_classes=10), pt.resnet18(
            num_classes=10, device="cpu"), (1, 3, 32, 32), None
    paddle.seed(0)
    return JaxCls(jax_bert_tiny()), pt.BertForSequenceClassification(
        pt.bert_tiny(), device="cpu"), (2, 16), "int64"


@pytest.mark.parametrize("name", ["lenet", "resnet18", "bert_tiny"])
def test_summary_and_flops_totals_equal_jax(name, capsys, monkeypatch):
    """``flops`` probes with f32 zeros in both packages. The JAX BERT's
    embedding refuses f32 ids (the port's casts them), so for BERT the JAX
    total is taken with its zeros made integer."""
    jnet, tnet, size, dtype = _summary_pair(name)
    want = paddle.summary(jnet, size, dtypes=dtype)
    got = pt.summary(tnet, size, dtypes=dtype)
    assert got == want
    out = capsys.readouterr().out
    assert f"Total params: {want['total_params']:,}" in out
    if dtype == "int64":
        zeros = jnp.zeros
        monkeypatch.setattr(jnp, "zeros", lambda shape, dtype=None, **kw:
                            zeros(shape, jnp.int32, **kw))
    want_flops = paddle.flops(jnet, list(size))
    monkeypatch.undo()
    assert pt.flops(tnet, list(size)) == want_flops > 0
    assert tnet.training  # the summary's eval pass restores the mode


def test_flops_of_a_bare_layer_and_custom_ops():
    paddle.seed(0)
    jlin = paddle.nn.Linear(8, 4)
    tlin = pt.nn.Linear(8, 4)
    assert pt.flops(tlin, [3, 8]) == paddle.flops(jlin, [3, 8]) == 96
    seq = pt.nn.Sequential(pt.nn.Linear(8, 4), pt.nn.Identity())
    assert pt.flops(seq, [3, 8], custom_ops={pt.nn.Identity:
                                             lambda m, x, y: 7}) == 96 + 7


# ------------------------------------------------------------ Model.fit

def test_lenet_fit_evaluate_predict_match_jax():
    """LeNet with ``Adam(1e-3)`` and top-(1, 5) accuracy: the fit history
    (two epochs), the final weights, ``evaluate`` and ``predict``."""
    jmodel, tmodel = _lenet_models(30)
    x, y = _lenet_data(31, 48)
    jh = jmodel.fit(_ds(jio, x, y), batch_size=16, epochs=2, shuffle=False,
                    verbose=0)
    th = tmodel.fit(_ds(tio, x, y), batch_size=16, epochs=2, shuffle=False,
                    verbose=0)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=RTOL,
                               atol=ATOL)
    _assert_weights_close(jmodel.network, tmodel.network)
    assert tmodel._step_fn.stats()["graph_breaks"] == 0
    ex, ey = _lenet_data(32, 20)
    _assert_logs_close(tmodel.evaluate(_ds(tio, ex, ey), batch_size=8),
                       jmodel.evaluate(_ds(jio, ex, ey), batch_size=8))
    jp = jmodel.predict(_ds(jio, ex, ey), batch_size=8, stack_outputs=True)
    tp = tmodel.predict(_ds(tio, ex, ey), batch_size=8, stack_outputs=True)
    assert tp[0].shape == (20, 10)
    np.testing.assert_allclose(tp[0], jp[0], rtol=RTOL, atol=1e-4)
    assert tmodel.network.training


@pytest.mark.parametrize("amp", [None, "O1"])
def test_bert_fit_with_lr_scheduler_callback_matches_jax(amp):
    """``BertForSequenceClassification(bert_tiny())`` with ``AdamW`` under
    ``LinearWarmup(PolynomialDecay)`` stepped each batch by
    ``callbacks.LRScheduler``: history, lr and weights (f32); under O1
    bf16 the losses to bf16 precision."""
    jmodel, tmodel, js, ts = _bert_models(40, amp=amp)
    ids, labels = _bert_data(41, 32)
    jh = jmodel.fit(_ds(jio, ids, labels), batch_size=8, epochs=2,
                    shuffle=False, verbose=0,
                    callbacks=[jcb.LRScheduler(by_step=True)])
    th = tmodel.fit(_ds(tio, ids, labels), batch_size=8, epochs=2,
                    shuffle=False, verbose=0,
                    callbacks=[tcb.LRScheduler(by_step=True)])
    assert ts.last_epoch == js.last_epoch == 8
    assert ts() == pytest.approx(js(), rel=1e-12)
    assert tmodel._step_fn.stats()["graph_breaks"] == 0
    if amp is None:
        np.testing.assert_allclose(th["loss"], jh["loss"], rtol=RTOL,
                                   atol=ATOL)
        _assert_weights_close(jmodel.network, tmodel.network)
    else:
        np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-2)
    eids, elabels = _bert_data(42, 16)
    te = tmodel.evaluate(_ds(tio, eids, elabels), batch_size=8)
    je = jmodel.evaluate(_ds(jio, eids, elabels), batch_size=8)
    if amp is None:
        _assert_logs_close(te, je)
    else:
        np.testing.assert_allclose(te["loss"], je["loss"], rtol=1e-2)


def test_fit_through_a_dataloader_with_workers_equals_in_process():
    x, y = _lenet_data(33, 32)
    hist = []
    for kw in ({"num_workers": 0, "use_buffer_reader": False},
               {"num_workers": 0}, {"num_workers": 2, "timeout": 60}):
        _, tmodel = _lenet_models(34)
        loader = tio.DataLoader(_ds(tio, x, y), batch_size=8, places="cpu",
                                **kw)
        hist.append(tmodel.fit(loader, epochs=2, verbose=0)["loss"])
    assert hist[0] == hist[1] == hist[2]


# ------------------------------------------------------------ callbacks

def test_early_stopping_equals_jax():
    logs = [0.9, 0.8, 0.85, 0.79, 0.795, 0.81, 0.7]
    for mode, patience, delta in (("min", 0, 0), ("min", 1, 0.005),
                                  ("max", 1, 0)):
        j = jcb.EarlyStopping(monitor="loss", mode=mode, patience=patience,
                              min_delta=delta)
        t = tcb.EarlyStopping(monitor="loss", mode=mode, patience=patience,
                              min_delta=delta)
        for v in logs:
            j.on_eval_end({"loss": v})
            t.on_eval_end({"loss": v})
            assert (t.best, t.wait, t.stop_training) == \
                (j.best, j.wait, j.stop_training)
        t.on_eval_end({"acc": 1.0})  # a missing monitor changes nothing
        assert t.wait == j.wait


def test_early_stopping_ends_fit_at_jax_epoch():
    """``mode="max"`` on a falling eval loss: both stop after the second
    epoch."""
    x, y = _lenet_data(35, 32)
    ex, ey = _lenet_data(36, 16)
    jmodel, tmodel = _lenet_models(37, metrics=False)
    jh = jmodel.fit(_ds(jio, x, y), _ds(jio, ex, ey), batch_size=16,
                    epochs=5, shuffle=False, verbose=0,
                    callbacks=[jcb.EarlyStopping(mode="max", patience=0)])
    th = tmodel.fit(_ds(tio, x, y), _ds(tio, ex, ey), batch_size=16,
                    epochs=5, shuffle=False, verbose=0,
                    callbacks=[tcb.EarlyStopping(mode="max", patience=0)])
    assert len(th["loss"]) == len(jh["loss"]) < 5
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=RTOL, atol=ATOL)


def test_reduce_lr_on_plateau_equals_jax():
    seq = [1.0, 1.0, 1.0, 0.5, 0.5, 0.5, 0.5, 0.5, 0.2, [0.2], 0.2]
    lrs = []
    for pkg, cb_mod in ((paddle, jcb), (pt, tcb)):
        if pkg is paddle:
            paddle.seed(0)
            net = paddle.nn.Linear(4, 2)
            opt = paddle.optimizer.Adam(learning_rate=0.1,
                                        parameters=net.parameters())
            model = paddle.Model(net)
        else:
            net = pt.nn.Linear(4, 2)
            opt = pt.Adam(learning_rate=0.1, parameters=net.parameters())
            model = pt.Model(net)
        model.prepare(optimizer=opt, loss=pkg.nn.MSELoss())
        cb = cb_mod.ReduceLROnPlateau(patience=2, factor=0.5, cooldown=1,
                                      min_lr=0.02, verbose=0)
        cb.set_model(model)
        got = []
        for v in seq:
            cb.on_eval_end({"loss": v})
            got.append(opt.get_lr())
        lrs.append(got)
    assert lrs[1] == pytest.approx(lrs[0], rel=1e-12)
    assert lrs[1][2] == pytest.approx(0.05)


def test_lr_scheduler_callback_by_epoch_equals_jax():
    x, y = _lenet_data(38, 32)
    out = []
    for pkg, io, cb_mod in ((paddle, jio, jcb), (pt, tio, tcb)):
        if pkg is paddle:
            paddle.seed(39)
            net = JaxLeNet()
        else:
            net = _carry(JaxLeNet(), pt.LeNet(device="cpu", seed=None))
        sched = pkg.optimizer.lr.StepDecay(1e-3, step_size=1, gamma=0.5)
        model = pkg.Model(net)
        model.prepare(pkg.optimizer.Adam(sched, parameters=net.parameters()),
                      pkg.nn.CrossEntropyLoss())
        model.fit(_ds(io, x, y), batch_size=16, epochs=3, shuffle=False,
                  verbose=0, callbacks=[cb_mod.LRScheduler(by_step=False,
                                                           by_epoch=True)])
        out.append((sched.last_epoch, sched()))
    assert out[1] == pytest.approx(out[0])
    assert out[1][0] == 3


def test_model_checkpoint_writes_what_jax_writes(tmp_path):
    x, y = _lenet_data(43, 32)
    jmodel, tmodel = _lenet_models(44, metrics=False)
    jmodel.fit(_ds(jio, x, y), batch_size=16, epochs=2, shuffle=False,
               verbose=0, callbacks=[jcb.ModelCheckpoint(
                   save_dir=str(tmp_path / "jax"))])
    tmodel.fit(_ds(tio, x, y), batch_size=16, epochs=2, shuffle=False,
               verbose=0, callbacks=[tcb.ModelCheckpoint(
                   save_dir=str(tmp_path / "port"))])
    for epoch in (0, 1):
        for ext in (".pdparams", ".pdopt"):
            assert (tmp_path / "port" / f"{epoch}{ext}").exists()
        want = paddle.load(str(tmp_path / "jax" / f"{epoch}.pdparams"),
                           return_numpy=True)
        got = pt.load(str(tmp_path / "port" / f"{epoch}.pdparams"),
                      return_numpy=True)
        assert got.keys() == want.keys()
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=RTOL,
                                       atol=ATOL, err_msg=name)


def test_prog_bar_logger_prints_step_and_epoch_lines(capsys):
    x, y = _lenet_data(45, 32)
    _, tmodel = _lenet_models(46)
    tmodel.fit(_ds(tio, x, y), batch_size=16, epochs=1, shuffle=False,
               verbose=2, log_freq=1)
    out = capsys.readouterr().out
    assert "epoch 0 step 1: loss:" in out and "acc:" in out
    assert "ips" in out and "epoch 0 done: loss:" in out


# ------------------------------------------- host syncs and telemetry

def _fit_model(seed=0):
    g = torch.Generator().manual_seed(seed)
    net = pt.nn.Linear(16, 4, generator=g)
    model = pt.Model(net)
    model.prepare(optimizer=pt.Adam(learning_rate=1e-2,
                                    parameters=net.parameters()),
                  loss=pt.nn.MSELoss())
    return model


def _fit_ds(n_batches=12, bs=4):
    x = np.random.RandomState(42).randn(n_batches * bs, 16).astype(
        "float32")
    y = x @ np.random.RandomState(7).randn(16, 4).astype("float32")
    return _ds(tio, x, y)


def test_fit_bounded_host_syncs_per_step(monkeypatch):
    """``tests/test_perf_hotpath.py:348-377``: the fit loop issues a
    bounded number of blocking host syncs, counted through its one fetch
    funnel (``Model._fetch_scalar`` / ``_fetch_scalars``)."""
    scalar_fetches = {"n": 0}
    batch_fetches = {"n": 0}
    real_scalar = PortModel._fetch_scalar
    real_batch = PortModel._fetch_scalars

    def count_scalar(loss):
        scalar_fetches["n"] += 1
        return real_scalar(loss)

    def count_batch(losses):
        batch_fetches["n"] += 1
        return real_batch(losses)

    monkeypatch.setattr(PortModel, "_fetch_scalar",
                        staticmethod(count_scalar))
    monkeypatch.setattr(PortModel, "_fetch_scalars",
                        staticmethod(count_batch))
    model = _fit_model()
    steps = 12
    hist = model.fit(_fit_ds(steps), batch_size=4, epochs=1, shuffle=False,
                     verbose=0, loss_fetch_every=4)
    # fetch cadence 4 over 12 steps -> 3 scalar fetches (steps 0, 4, 8)
    # and ONE stacked epoch-end fetch for the lazy remainder
    assert scalar_fetches["n"] == 3, scalar_fetches
    assert batch_fetches["n"] == 1, batch_fetches
    assert len(hist["loss"]) == 1 and np.isfinite(hist["loss"][0])


def test_fit_amortized_history_matches_per_step_fetch():
    """``tests/test_perf_hotpath.py:380-390``: epoch means are exact under
    the amortized fetch."""
    def run(fetch_every):
        return _fit_model(5).fit(_fit_ds(8), batch_size=4, epochs=2,
                                 shuffle=False, verbose=0,
                                 loss_fetch_every=fetch_every)

    np.testing.assert_allclose(run(1)["loss"], run(50)["loss"], rtol=1e-6)


def test_telemetry_counts_every_step_as_jax():
    """``tests/test_perf_hotpath.py:440-460``: with metrics on and the
    amortized fetch, every step observes the full split; the port's
    counts equal the JAX package's on the same loop."""
    reg = tmetrics.enable()
    _fit_model(5).fit(_fit_ds(12), batch_size=4, epochs=1, shuffle=False,
                      verbose=0, loss_fetch_every=4)
    snap = reg.snapshot()
    from paddle_tpu.observability import metrics as jmetrics
    jreg = jmetrics.enable()
    try:
        paddle.seed(5)
        net = paddle.nn.Linear(16, 4)
        jmodel = paddle.Model(net)
        jmodel.prepare(optimizer=paddle.optimizer.Adam(
            learning_rate=1e-2, parameters=net.parameters()),
            loss=paddle.nn.MSELoss())
        x = np.random.RandomState(42).randn(48, 16).astype("float32")
        jmodel.fit(_ds(jio, x, x[:, :4]), batch_size=4, epochs=1,
                   shuffle=False, verbose=0, loss_fetch_every=4)
        jsnap = jreg.snapshot()
    finally:
        jmetrics.disable()
    assert snap["counters"]["steps_total"] == \
        jsnap["counters"]["steps_total"] == 12
    assert snap["counters"]["tokens_total"] == \
        jsnap["counters"]["tokens_total"] == 48
    for h in ("step_time_ms", "compute_ms", "sync_ms", "data_wait_ms"):
        assert snap["histograms"][h]["count"] == \
            jsnap["histograms"][h]["count"] == 12, h
    assert "mfu_pct" not in snap["gauges"]  # no card, no peak: no MFU
    assert ttelemetry._active is None


def test_telemetry_mfu_from_the_peak_override(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "1e9")
    reg = tmetrics.enable()
    _fit_model(5).fit(_fit_ds(4), batch_size=4, epochs=1, shuffle=False,
                      verbose=0)
    gauges = reg.snapshot()["gauges"]
    assert gauges["mfu_pct"] > 0 and gauges["tokens_per_sec"] > 0


def test_peak_flops_knows_the_h100_and_nothing_else(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_PEAK_FLOPS", raising=False)
    assert tmetrics.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert tmetrics.peak_flops("NVIDIA H100 PCIe") == 756e12
    for kind in ("", "TPU v5 lite", "NVIDIA A100-SXM4-80GB"):
        assert tmetrics.peak_flops(kind) is None
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "123.0")
    assert tmetrics.peak_flops("anything") == 123.0


def test_ema_timer_matches_jax():
    from paddle_tpu.observability.telemetry import EMATimer as JaxTimer
    j, t = JaxTimer(alpha=0.4), ttelemetry.EMATimer(alpha=0.4)
    for now in (1.0, 1.5, 1.7, 2.6):
        assert t.tick(now) == j.tick(now)
    t.reset()
    assert t.tick(5.0) == (None, t.ema)


# ------------------------------------------------------------ save, load

def _mixed_state(rng):
    return {"w": rng.randn(3, 4).astype(np.float32),
            "ids": np.arange(5, dtype=np.int64),
            "half": rng.randn(6).astype(np.float16),
            "bf16": rng.randn(2, 3).astype(np.float32),
            "nested": [{"b": rng.randn(2).astype(np.float32)}, 7],
            "LR_Scheduler": {"last_epoch": 3, "last_lr": 0.5},
            "global_step": 11}


def test_a_port_file_loads_in_jax_bf16_included(tmp_path):
    s = _mixed_state(np.random.RandomState(0))
    obj = {"w": torch.from_numpy(s["w"]).requires_grad_(True),
           "ids": torch.from_numpy(s["ids"]),
           "half": torch.from_numpy(s["half"]),
           "bf16": torch.from_numpy(s["bf16"]).bfloat16(),
           "nested": [{"b": torch.from_numpy(s["nested"][0]["b"])}, 7],
           "LR_Scheduler": s["LR_Scheduler"], "global_step": 11}
    pt.save(obj, str(tmp_path / "sub" / "port.pdparams"))
    got = paddle.load(str(tmp_path / "sub" / "port.pdparams"))
    for k in ("w", "ids", "half"):
        np.testing.assert_array_equal(np.asarray(got[k]._data), s[k])
    assert got["bf16"]._data.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(got["bf16"]._data, np.float32),
        obj["bf16"].float().numpy())
    assert not got["w"].stop_gradient and got["ids"].stop_gradient
    np.testing.assert_array_equal(np.asarray(got["nested"][0]["b"]._data),
                                  s["nested"][0]["b"])
    assert got["nested"][1] == 7 and got["global_step"] == 11
    assert got["LR_Scheduler"] == s["LR_Scheduler"]


def test_a_jax_file_loads_in_the_port_bf16_included(tmp_path):
    s = _mixed_state(np.random.RandomState(1))
    obj = {"w": Tensor(jnp.asarray(s["w"]), stop_gradient=False),
           "ids": Tensor(jnp.asarray(s["ids"])),
           "half": Tensor(jnp.asarray(s["half"])),
           "bf16": Tensor(jnp.asarray(s["bf16"], jnp.bfloat16)),
           "nested": [{"b": Tensor(jnp.asarray(s["nested"][0]["b"]))}, 7],
           "LR_Scheduler": s["LR_Scheduler"], "global_step": 11}
    paddle.save(obj, str(tmp_path / "jax.pdparams"))
    got = pt.load(str(tmp_path / "jax.pdparams"), device="cpu")
    assert got["bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["bf16"].float().numpy(),
        np.asarray(obj["bf16"]._data, np.float32))
    for k in ("w", "ids", "half"):
        assert got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy() if k != "w" else
                                      got[k].detach().numpy(), s[k])
    assert got["w"].requires_grad and not got["ids"].requires_grad
    assert got["nested"][1] == 7 and got["global_step"] == 11
    as_np = pt.load(str(tmp_path / "jax.pdparams"), return_numpy=True)
    assert isinstance(as_np["w"], np.ndarray)
    assert as_np["bf16"].dtype == np.float32
    np.testing.assert_array_equal(as_np["bf16"], got["bf16"].float().numpy())


def _name_map(jnet):
    return {p.name: n for n, p in jnet.named_parameters()}


def test_a_jax_model_checkpoint_resumes_in_the_port(tmp_path):
    """JAX ``Model.save`` -> the port's ``Model.load`` (the optimizer's
    state through the JAX parameter names): evaluation equal, then one
    more fit epoch equal."""
    x, y = _lenet_data(47, 32)
    jmodel, _ = _lenet_models(48)
    jmodel.fit(_ds(jio, x, y), batch_size=16, epochs=1, shuffle=False,
               verbose=0)
    jmodel.save(str(tmp_path / "jax"))
    tnet = pt.LeNet(device="cpu", seed=None)
    tmodel = pt.Model(tnet)
    tmodel.prepare(pt.Adam(1e-3, parameters=tnet.parameters()),
                   pt.nn.CrossEntropyLoss(),
                   pt.metric.Accuracy(topk=(1, 5)))
    tmodel.load(str(tmp_path / "jax"), name_map=_name_map(jmodel.network))
    _assert_weights_close(jmodel.network, tnet, rtol=0, atol=0)
    ex, ey = _lenet_data(49, 16)
    _assert_logs_close(tmodel.evaluate(_ds(tio, ex, ey), batch_size=8),
                       jmodel.evaluate(_ds(jio, ex, ey), batch_size=8))
    jh = jmodel.fit(_ds(jio, x, y), batch_size=16, epochs=1, shuffle=False,
                    verbose=0)
    th = tmodel.fit(_ds(tio, x, y), batch_size=16, epochs=1, shuffle=False,
                    verbose=0)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=RTOL,
                               atol=ATOL)
    _assert_weights_close(jmodel.network, tnet)


def test_a_port_model_checkpoint_resumes_in_jax(tmp_path):
    """The port's ``Model.save`` -> JAX ``Model.load`` for the weights,
    and the optimizer's state renamed to the JAX names by
    ``opt_state_to_numpy``: one more epoch equal."""
    x, y = _lenet_data(50, 32)
    jmodel, tmodel = _lenet_models(51, metrics=False)
    tmodel.fit(_ds(tio, x, y), batch_size=16, epochs=1, shuffle=False,
               verbose=0)
    tmodel.save(str(tmp_path / "port"))
    jmodel.load(str(tmp_path / "port"))
    state = pt.load(str(tmp_path / "port.pdopt"), device="cpu")
    jmodel._optimizer.set_state_dict(pt.opt_state_to_numpy(
        state, _name_map(jmodel.network)))
    _assert_weights_close(jmodel.network, tmodel.network, rtol=0, atol=0)
    jh = jmodel.fit(_ds(jio, x, y), batch_size=16, epochs=1, shuffle=False,
                    verbose=0)
    th = tmodel.fit(_ds(tio, x, y), batch_size=16, epochs=1, shuffle=False,
                    verbose=0)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=RTOL,
                               atol=ATOL)
    _assert_weights_close(jmodel.network, tmodel.network)


def test_port_round_trip_keeps_optimizer_state(tmp_path):
    x, y = _lenet_data(52, 32)
    _, tmodel = _lenet_models(53)
    tmodel.fit(_ds(tio, x, y), batch_size=16, epochs=1, shuffle=False,
               verbose=0)
    tmodel.save(str(tmp_path / "ck"))
    tnet = pt.LeNet(device="cpu", seed=None)
    fresh = pt.Model(tnet)
    fresh.prepare(pt.Adam(1e-3, parameters=tnet.parameters()),
                  pt.nn.CrossEntropyLoss())
    fresh.load(str(tmp_path / "ck"))
    want = tmodel._optimizer.state_dict()
    got = fresh._optimizer.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        if torch.is_tensor(want[k]):
            assert torch.equal(got[k], want[k]), k
        else:
            assert got[k] == want[k], k
    fresh.load(str(tmp_path / "ck"), reset_optimizer=True)


# --------------------------------------------- not ported: refused

def test_parts_not_ported_raise(tmp_path, monkeypatch):
    x, y = _lenet_data(54, 16)
    _, tmodel = _lenet_models(55, metrics=False)
    with pytest.raises(NotImplementedError, match="item 4"):
        tmodel.fit(_ds(tio, x, y), batch_size=8, verbose=0,
                   lineage=str(tmp_path / "lineage"))
    with pytest.raises(NotImplementedError, match="item 4"):
        tmodel.fit(_ds(tio, x, y), batch_size=8, verbose=0, integrity=True)
    # ported since: the inference export goes through jit.save, which
    # needs the Model's inputs, as in JAX
    with pytest.raises(ValueError, match="input_spec"):
        tmodel.save(str(tmp_path / "infer"), training=False)
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    with pytest.raises(NotImplementedError, match="DataParallel"):
        tmodel.prepare(pt.Adam(1e-3, parameters=tmodel.parameters()),
                       pt.nn.CrossEntropyLoss())


def test_update_false_accumulates_gradients_eagerly():
    _, tmodel = _lenet_models(56, metrics=False)
    x, y = _lenet_data(57, 8)
    loss = tmodel.train_batch(torch.from_numpy(x), torch.from_numpy(y),
                              update=False)
    assert np.isfinite(loss)
    assert all(p.grad is not None for p in tmodel.parameters())
    assert tmodel._step_fn is None
