"""The port's training integrity guard against ``paddle_tpu``'s on the
CPU: ``MADWindow`` verdicts and z-scores, ``verify_fingerprints``,
``TrainingGuard`` (streaks, nonfinite, rewind-and-skip through the
lineage, ``max_rewinds``, mismatch redo budget), ``make_guard``,
``GradFingerprints``' summaries, ``IntegrityError``'s exit code, the
skip windows a snapshot carries, ``fit``'s structural cost of
``integrity=``, and a ``loss_spike`` rewound and skipped in ``fit``
(bit-equal to a clean run that skips the same window). The cases follow
``tests/test_integrity.py``; each runs through both packages and the
results are compared. Also the repair the loss-spike path needed: the
port's ``cross_entropy`` gives JAX's NaN for a label out of range (it
raised on the CPU, and asserts on the card).

Tolerances: z-scores ``rtol 1e-12`` (float64 on the host in both),
losses f32 ``rtol 1e-4 / atol 1e-5``.
"""
import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed import fault as jfault
from paddle_tpu.distributed import integrity as jint
from paddle_tpu.distributed import resumable as jres
from paddle_tpu.observability import report as jreport

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import device as port_device
from paddle_tpu_torch.distributed import fault
from paddle_tpu_torch.distributed import flight_recorder
from paddle_tpu_torch.distributed import integrity as tint
from paddle_tpu_torch.distributed import resumable as tres
from paddle_tpu_torch.hapi.model import Model as PortModel
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability import report as treport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"port": tint, "jax": jint}


@pytest.fixture(autouse=True)
def _reset_process_state(monkeypatch):
    """Fault specs, the preemption flag, the recorder, the port's metrics
    and the SIGTERM disposition put back around each test."""
    monkeypatch.setattr(port_device, "DEFAULT_DEVICE", "cpu")
    monkeypatch.delenv("PADDLE_TPU_FAULTS", raising=False)
    monkeypatch.delenv("PADDLE_TPU_FAULT_LEDGER", raising=False)
    prev = signal.getsignal(signal.SIGTERM)
    for f in (fault, jfault):
        f.set_fault_spec(None)
        f._preempt_event.clear()
    flight_recorder._reset_state()
    tmetrics._reset_state()
    yield
    signal.signal(signal.SIGTERM, prev)
    for f in (fault, jfault):
        f.set_fault_spec(None)
        f._preempt_event.clear()
    flight_recorder._reset_state()
    tmetrics._reset_state()


# ------------------------------------------------------------ health gate
_STREAMS = {
    "warmup": ((8, 4.0, 5), [100.0, 10.0, 1.0, 0.1, 50.0]),
    "spike": ((16, 8.0, 4), [2.0 + 0.01 * (i % 3) for i in range(12)]
              + [2000.0, 2.01]),
    "lr_decay": ((16, 8.0, 4), [2.0 * 0.95 ** i for i in range(60)]),
    "constant": ((8, 8.0, 2), [1.0] * 6 + [1.5]),
    "noisy": ((8, 3.0, 3), list(np.random.RandomState(5).randn(40) * 0.1
                               + 2.0) + [3.0, 1.0, 2.0]),
}


@pytest.mark.parametrize("case", sorted(_STREAMS))
def test_mad_window_verdicts_and_z_match_jax(case):
    (window, z, warmup), values = _STREAMS[case]
    got = {}
    for name, pkg in PKGS.items():
        w = pkg.MADWindow(window=window, z_threshold=z, warmup=warmup)
        got[name] = [(w.observe(v), w.last_z) for v in values]
    assert [t for t, _ in got["port"]] == [t for t, _ in got["jax"]]
    np.testing.assert_allclose([z for _, z in got["port"]],
                               [z for _, z in got["jax"]], rtol=1e-12)
    if case == "spike":
        assert [t for t, _ in got["port"]][-2:] == [True, False]


def _fp(fp, injected=False):
    return {"fp": fp, "injected": injected}


@pytest.mark.parametrize("fps", [
    {0: _fp("a"), 1: _fp("b"), 2: _fp("a")},
    {0: _fp("a"), 1: _fp("a")}, {0: _fp("a")}, {},
    {0: _fp("good"), 1: _fp("flipped", True)},
    {0: _fp("flipped", True), 1: _fp("good")},
    {0: _fp("a"), 1: _fp("b"), 2: _fp("a"), 3: _fp("b")}])
def test_verify_fingerprints_matches_jax(fps):
    assert tint.verify_fingerprints(fps) == jint.verify_fingerprints(fps)


def _guard_story(pkg, res, root):
    """The guard's streak -> rewind -> budget story of
    ``tests/test_integrity.py`` in one package -> what it reported."""
    g = pkg.TrainingGuard(window=16, warmup=2, z_threshold=8.0,
                          rewind_after=2, max_rewinds=1, verbose=False)
    rt = res.ResumableTraining(root, verbose=False)
    rt.ensure_baseline()
    out = [g.observe_loss(v, 0, i, i)
           for i, v in enumerate((2.0, 2.2, 1.9, 2.1, 2.05, 5000.0, 4000.0))]
    out.append(dict(g.anomalies))
    out.append(g.rewind(rt, 0, 6))
    out.append(sorted(rt.skip_windows))
    with pytest.raises(pkg.IntegrityError, match="max_rewinds"):
        g.rewind(rt, 0, 7)
    g2 = pkg.TrainingGuard(warmup=50, rewind_after=3, verbose=False)
    out.append([g2.observe_loss(v, 0, i, i) for i, v in enumerate(
        (float("nan"), float("inf"), 1.0, float("nan"), float("nan"),
         float("inf")))])
    out.append(dict(g2.anomalies))
    with pytest.raises(pkg.IntegrityError, match="no lineage"):
        pkg.TrainingGuard(rewind_after=1, verbose=False).rewind(None, 0, 0)
    return out


def test_guard_verdicts_match_jax(tmp_path):
    port = _guard_story(tint, tres, str(tmp_path / "p"))
    jax_ = _guard_story(jint, jres, str(tmp_path / "j"))
    assert port == jax_
    assert port[5:7] == ["anomaly", "rewind"]
    assert port[9] == [(0, 5, 6)]


class _Strikes:
    def __init__(self):
        self.struck = []

    def record_failure(self, name):
        self.struck.append(name)
        return len(self.struck) >= 2


def test_mismatch_blame_and_redo_budget_match_jax():
    out = {}
    for name, pkg in PKGS.items():
        q = _Strikes()
        g = pkg.TrainingGuard(max_redos=2, quarantine=q, verbose=False)
        err = pkg.GradFingerprintMismatch("diverged", blamed=[1], bucket=0)
        g.on_mismatch(err, 0, 3)
        g.on_mismatch(err, 0, 3)
        with pytest.raises(pkg.IntegrityError, match="persistent"):
            g.on_mismatch(err, 0, 3)
        g.on_mismatch(err, 0, 4)
        out[name] = (dict(g.blames), dict(g.anomalies), q.struck)
    assert out["port"] == out["jax"]


def test_make_guard_and_fingerprints_degrade_as_jax(capsys):
    assert tint.make_guard(None) is None and tint.make_guard(False) is None
    g = tint.make_guard({"window": 4, "rewind_after": 7})
    assert g.mad.window == 4 and g.rewind_after == 7
    assert tint.make_guard(g) is g
    with pytest.raises(TypeError):
        tint.make_guard("yes")
    g = tint.TrainingGuard(fingerprints=True, verbose=False)
    g.attach_fingerprints(pt.nn.Linear(4, 2, device="cpu"))
    assert not g.fingerprints_active()
    assert "health gates only" in capsys.readouterr().err


class _DictStore:
    def __init__(self):
        self.kv = {}

    def set(self, k, v):
        self.kv[k] = v if isinstance(v, bytes) else str(v).encode()

    def get(self, k, timeout=None):
        return self.kv[k]

    def wait(self, keys, timeout=None):
        assert all(k in self.kv for k in keys)


@pytest.mark.parametrize("flip", [False, True])
def test_grad_fingerprints_match_jax(flip):
    """The same bucket payload summarized by both packages (a torch
    tensor in the port, a numpy array in JAX) gives the same fingerprint;
    ``grad_bitflip`` perturbs the host sample alike."""
    flat = np.random.RandomState(9).randn(5000).astype(np.float32)
    recs = {}
    for name, pkg, f, payload in (
            ("port", tint, fault, torch.from_numpy(flat.copy())),
            ("jax", jint, jfault, flat.copy())):
        f.set_fault_spec("grad_bitflip@grad_fingerprint:1" if flip
                         else None)
        fp = pkg.GradFingerprints(0, 1, stride=7)
        fp._store, fp._store_tried = _DictStore(), True
        fp.begin_round()
        fp.on_bucket(0, payload)
        recs[name] = list(fp._store.kv.values())
    assert recs["port"] == recs["jax"]


def test_integrity_error_exits_49():
    code = ("from paddle_tpu_torch.distributed import integrity as i\n"
            "i.TrainingGuard()\n"
            "raise i.IntegrityError('guard verdict')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == fault.EXIT_INTEGRITY == 49, r.stderr
    assert "guard verdict" in r.stderr


def test_skip_windows_roundtrip_and_union_merge(tmp_path):
    rt = tres.ResumableTraining(str(tmp_path / "ck"), verbose=False)
    rt.add_skip_window(0, 4, 5)
    rt.ensure_baseline()
    rt.finalize()
    rt2 = tres.ResumableTraining(str(tmp_path / "ck"), verbose=False)
    assert rt2.restore() is not None
    assert rt2.skip_windows == {(0, 4, 5)}
    assert rt2.skip_batch(0, 4) and not rt2.skip_batch(1, 4)
    assert rt2.rewind(skip_window=(0, 7, 8)) == 0
    assert rt2.skip_windows == {(0, 4, 5), (0, 7, 8)}
    with pytest.raises(RuntimeError, match="no verified snapshot"):
        tres.ResumableTraining(str(tmp_path / "none"),
                               verbose=False).rewind((0, 0, 0))
    rt3 = tres.ResumableTraining(str(tmp_path / "i"), interval=1,
                                 verbose=False)
    assert rt3.step_done(0, 0, suspect=True) is False
    assert rt3.step_done(0, 1) is True


def test_report_integrity_section_matches_jax():
    snap = {"ts": 1.0, "rank": 0, "seq": 0,
            "counters": {"train_anomalies_total{kind=loss_spike}": 2,
                         "train_anomalies_total{kind=nonfinite}": 1,
                         "train_rewinds_total": 1,
                         "integrity_blames_total{rank=1}": 3},
            "gauges": {}, "histograms": {}}
    port = treport.build_run_report({0: [snap]})
    assert port == jreport.build_run_report({0: [snap]})
    text = treport.format_run_report(port)
    assert text == jreport.format_run_report(port)
    assert "integrity: anomalies loss_spike=2, nonfinite=1" in text


@pytest.mark.parametrize("labels", [[0, 1000, 1, 0], [0, -1, 2, 1],
                                    [0, -5, 2, 1], [5, -100, 1, 1]])
@pytest.mark.parametrize("reduction", ["mean", "none"])
@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_out_of_range_labels_match_jax(labels, reduction,
                                                     weighted):
    """A label outside the classes gives NaN, as JAX's fill-mode gather
    does (the port raised an index error here); a negative one inside
    counts from the end, for its class weight too; ``ignore_index``
    still contributes 0."""
    x = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    w = np.array([0.5, 2.0, 3.0], np.float32) if weighted else None
    got = F.cross_entropy(torch.from_numpy(x), torch.tensor(labels),
                          weight=None if w is None else torch.from_numpy(w),
                          reduction=reduction)
    want = JF.cross_entropy(paddle.to_tensor(x),
                            paddle.to_tensor(np.array(labels)),
                            weight=None if w is None else paddle.to_tensor(w),
                            reduction=reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------- fit wiring
def _data():
    x = np.random.RandomState(42).randn(48, 16).astype("float32")
    y = x @ np.random.RandomState(7).randn(16, 4).astype("float32")
    return x, y


def _ds(x, y):
    class DS(pt.io.Dataset):
        def __getitem__(self, i):
            return x[i], y[i]

        def __len__(self):
            return len(x)

    return DS()


class _Rec(pt.hapi.callbacks.Callback):
    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])


def _model(sgd=False):
    pt.seed(0)
    net = pt.nn.Sequential(pt.nn.Linear(16, 32), pt.nn.ReLU(),
                           pt.nn.Dropout(0.25), pt.nn.Linear(32, 4))
    model = pt.Model(net)
    # SGD, as the JAX test: Adam's normalised step would take the spike's
    # gradient in stride, and only the poisoned batch itself would trip
    opt = pt.SGD(0.01, parameters=net.parameters()) if sgd else \
        pt.AdamW(1e-2, parameters=net.parameters())
    model.prepare(opt, pt.nn.MSELoss())
    return model


@pytest.mark.parametrize("guarded", [False, True])
def test_integrity_costs_the_per_step_fetch_only_when_on(monkeypatch,
                                                          guarded):
    calls = {"make_guard": 0, "scalar": 0, "batch": 0}
    real = (tint.make_guard, PortModel._fetch_scalar,
            PortModel._fetch_scalars)

    def count(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(tint, "make_guard", count("make_guard", real[0]))
    monkeypatch.setattr(PortModel, "_fetch_scalar",
                        staticmethod(count("scalar", real[1])))
    monkeypatch.setattr(PortModel, "_fetch_scalars",
                        staticmethod(count("batch", real[2])))
    x, y = _data()
    g = tint.TrainingGuard(warmup=100, verbose=False) if guarded else None
    _model().fit(_ds(x[:32], y[:32]), batch_size=4, epochs=1,
                 shuffle=False, verbose=0, loss_fetch_every=4, integrity=g)
    if guarded:
        assert calls["scalar"] == 8 and g.anomalies == {}
    else:
        # the amortized cadence: steps 0 and 4, one stacked epoch fetch
        assert calls == {"make_guard": 0, "scalar": 2, "batch": 1}


def test_loss_spike_rewinds_and_equals_the_clean_skip_twin(tmp_path,
                                                           capsys):
    """``loss_spike@batch:7`` scales batch 6's targets 1000x: the gate
    trips on the corrupted losses, the guard rewinds to the step-6
    snapshot and replays with the window skipped; the final weights and
    every loss after the window equal a clean run over the same data
    without those batches (the RNG state rides the snapshot, so even the
    dropout masks agree)."""
    x, y = _data()
    knobs = dict(window=16, warmup=3, z_threshold=8.0, rewind_after=2,
                 max_rewinds=2, verbose=True)
    fault.set_fault_spec("loss_spike@batch:7")
    poisoned, rec = _model(sgd=True), _Rec()
    g = tint.TrainingGuard(**knobs)
    poisoned.fit(_ds(x, y), batch_size=4, epochs=1, shuffle=False,
                 verbose=0, lineage=str(tmp_path / "p"), snapshot_interval=2,
                 integrity=g, callbacks=[rec])
    out = capsys.readouterr().out
    assert g.rewinds == 1 and g.anomalies.get("loss_spike", 0) >= 2
    assert "INTEGRITY_POISON" in out and "REWOUND global_step=6" in out
    first, last = map(int, re.search(r"INTEGRITY_REWIND n=1 to_step=6 "
                                     r"skip=\(0,(\d+),(\d+)\)",
                                     out).groups())
    assert (first, last) == (6, 7)
    fault.set_fault_spec(None)
    keep = [i for i in range(48) if not first * 4 <= i < (last + 1) * 4]
    clean, crec = _model(sgd=True), _Rec()
    clean.fit(_ds(x[keep], y[keep]), batch_size=4, epochs=1, shuffle=False,
              verbose=0, lineage=str(tmp_path / "c"), snapshot_interval=2,
              integrity=tint.TrainingGuard(**knobs), callbacks=[crec])
    for a, b in zip(poisoned.network.parameters(),
                    clean.network.parameters()):
        assert torch.equal(a, b)
    n_after = len(keep) // 4 - first
    assert rec.losses[-n_after:] == crec.losses[-n_after:]
