"""The port's resilient-training path against ``paddle_tpu`` on the CPU:
the fault grammar, ``Backoff`` / ``retry`` and ``CheckpointLineage``;
the sharded checkpoint (snapshots cross-load between the packages in
f32, a bf16 round trip in the port, a torn shard rejected by its CRC, an
async save equal to a sync one); ``Model.fit(lineage=...)`` (an
interrupted and resumed run equals its uninterrupted twin, its losses
equal the JAX package's, and a run started in JAX resumes in the port
from JAX's snapshot with JAX's losses); and the single-host launcher on
a CPU worker (``tests/torch_resilience_worker.py``): a crash with a torn
snapshot, a preemption that does not consume ``--max_restarts``, and a
two-process job whose peer dies.

Models are tiny MLPs; data numpy from a seed. Tolerances: f32 ``rtol
1e-4 / atol 1e-5`` against the JAX package; a resumed run's losses within
1e-6 of its uninterrupted twin (as ``tests/test_fault_tolerance.py``
holds the JAX launcher).
"""
import os
import re
import signal
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.hapi.callbacks as jcb
import paddle_tpu.io as jio
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.distributed import env as jax_dist_env
from paddle_tpu.distributed import fault as jfault

import paddle_tpu_torch as pt
import paddle_tpu_torch.hapi.callbacks as tcb
from paddle_tpu_torch import device as port_device
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.distributed import fault
from paddle_tpu_torch.distributed import flight_recorder
from paddle_tpu_torch.distributed import watchdog
from paddle_tpu_torch.distributed.launch import launch

import torch_resilience_worker as W

RTOL, ATOL = 1e-4, 1e-5
WORKER = os.path.abspath(W.__file__)


@pytest.fixture(autouse=True)
def _reset_process_state(monkeypatch):
    """The port's process-wide fault, preemption, recorder and watchdog
    state and the SIGTERM disposition, put back around each test
    (``ResumableTraining.restore`` installs a SIGTERM handler); the JAX
    package's parallel environment cleared, as
    ``tests/test_torch_port_hapi.py`` explains."""
    monkeypatch.setattr(jax_dist_env, "_initialized", False)
    monkeypatch.setattr(jax_dist_env, "_world_mesh", None)
    monkeypatch.setattr(port_device, "DEFAULT_DEVICE", "cpu")
    for var in ("PADDLE_TPU_FAULTS", "PADDLE_TPU_FAULT_LEDGER",
                "PADDLE_TPU_WATCHDOG_TIMEOUT", "PADDLE_TPU_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    prev = signal.getsignal(signal.SIGTERM)
    for f in (fault, jfault):
        f.set_fault_spec(None)
        f._preempt_event.clear()
    flight_recorder._reset_state()
    yield
    signal.signal(signal.SIGTERM, prev)
    for f in (fault, jfault):
        f.set_fault_spec(None)
        f._preempt_event.clear()
    flight_recorder._reset_state()
    watchdog.stop_step_watchdog()
    watchdog._disabled = False


# -------------------------------------------------------------- the faults
def test_fault_tables_and_exit_causes_match_jax():
    assert fault._KINDS == jfault._KINDS
    assert fault._WILDCARD_SITES == jfault._WILDCARD_SITES
    for rc in (0, 1, 17, 19, 21, 43, 47, 49, 64, 75, 76, -6, -9, -15, 3):
        assert fault.describe_exit(rc) == jfault.describe_exit(rc)
    assert fault.EXIT_INTEGRITY == jfault.EXIT_INTEGRITY == 49


@pytest.mark.parametrize("spec", [
    "crash@step:40,torn_write@ckpt:3", "loss_spike@batch:5",
    "hang@step:7%0", "grad_bitflip@grad_fingerprint:2%1",
    "store_drop:2, async_torn:1", "commit_stall@commit:1",
    "torn_write@ckpt:1%0,desync@allreduce:2"])
def test_fault_spec_parses_as_jax(spec):
    assert [e.key() for e in fault.parse_fault_spec(spec)] == \
        [e.key() for e in jfault.parse_fault_spec(spec)]


@pytest.mark.parametrize("spec", ["loss_spike@step:1", "torn_write@x:1",
                                  "grad_bitflip@batch:2"])
def test_fault_spec_refusals_match_jax(spec):
    for f in (fault, jfault):
        with pytest.raises(ValueError):
            f.parse_fault_spec(spec)


def test_backoff_and_retry_match_jax():
    kw = dict(base=0.01, cap=0.05, factor=3.0, jitter=0.3, attempts=6,
              seed=11)
    assert list(fault.Backoff(**kw)) == list(jfault.Backoff(**kw))

    def flaky(pkg, fail):
        calls, seen = [0], []

        def fn():
            calls[0] += 1
            if calls[0] <= fail:
                raise OSError(f"try {calls[0]}")
            return calls[0]
        try:
            out = pkg.retry(fn, retry_on=(OSError,), attempts=3, base=0.0,
                            jitter=0.0, seed=1,
                            on_retry=lambda e, d: seen.append(str(e)))
        except OSError as e:
            out = f"raised {e}"
        return out, seen

    for fail in (0, 2, 5):
        assert flaky(fault, fail) == flaky(jfault, fail)


def _lineage_story(pkg, ckpt_pkg, root):
    """Saves, a torn newest snapshot and a fallback load -> what the
    lineage did, in one package."""
    lin = pkg.CheckpointLineage(root, keep=2)
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    for step in (1, 2, 3):
        lin.save({"w": w * step, "step": step}, step)
    pkg.set_fault_spec("torn_write@ckpt:1")
    lin.save({"w": w * 4, "step": 4}, 4)
    pkg.set_fault_spec(None)
    out = {"candidates": [s for s, _ in lin.candidates()],
           "latest": lin.latest_committed()}
    target = {"w": np.zeros((2, 3), np.float32), "step": 0}
    if ckpt_pkg is jckpt:
        target["w"] = paddle.to_tensor(target["w"])
    out["loaded"] = lin.load_latest(target)
    w_loaded = target["w"]
    out["w"] = np.asarray(getattr(w_loaded, "_data", w_loaded)).tolist()
    out["step"] = target["step"]
    out["after"] = [s for s, _ in lin.candidates()]
    out["latest_after"] = lin.latest_committed()
    return out


def test_checkpoint_lineage_matches_jax(tmp_path, capfd):
    port = _lineage_story(fault, ckpt, str(tmp_path / "port"))
    jax_ = _lineage_story(jfault, jckpt, str(tmp_path / "jax"))
    assert port == jax_
    assert port["loaded"] == 3 and port["after"] == [3]
    assert port["latest"] == 4 and port["latest_after"] == 3
    assert capfd.readouterr().err.count("skipping snapshot") == 2


# ---------------------------------------------------------- the checkpoint
def _state(rng):
    return {"model": {"w": rng.randn(4, 3).astype(np.float32),
                      "b": rng.randn(3).astype(np.float32)},
            "ids": np.arange(5, dtype=np.int64), "epoch": 2,
            "tag": "x"}


def test_port_snapshot_loads_in_jax_and_back(tmp_path):
    src = _state(np.random.RandomState(0))
    port_in = {"model": {k: torch.from_numpy(v.copy())
                         for k, v in src["model"].items()},
               "ids": torch.from_numpy(src["ids"]), "epoch": 2, "tag": "x"}
    ckpt.save_state_dict(port_in, str(tmp_path / "p"))
    jt = {"model": {k: paddle.zeros(list(v.shape)) for k, v in
                    src["model"].items()},
          "ids": paddle.zeros([5], dtype="int64"), "epoch": 0, "tag": ""}
    jckpt.load_state_dict(jt, str(tmp_path / "p"))
    for k, v in src["model"].items():
        np.testing.assert_allclose(np.asarray(jt["model"][k]._data), v,
                                   rtol=RTOL, atol=ATOL)
    assert np.asarray(jt["ids"]._data).tolist() == src["ids"].tolist()
    assert (jt["epoch"], jt["tag"]) == (2, "x")
    # the reverse: the JAX package's snapshot into port tensors, in place
    jckpt.save_state_dict(
        {"model": {k: paddle.to_tensor(v) for k, v in src["model"].items()},
         "ids": paddle.to_tensor(src["ids"]), "epoch": 2, "tag": "x"},
        str(tmp_path / "j"))
    pt_ = {"model": {k: torch.zeros(v.shape) for k, v in
                     src["model"].items()},
           "ids": torch.zeros(5, dtype=torch.int64), "epoch": 0, "tag": ""}
    w_before = pt_["model"]["w"]
    ckpt.load_state_dict(pt_, str(tmp_path / "j"))
    assert pt_["model"]["w"] is w_before            # copied into
    for k, v in src["model"].items():
        np.testing.assert_allclose(pt_["model"][k].numpy(), v, rtol=RTOL,
                                   atol=ATOL)
    assert pt_["ids"].tolist() == src["ids"].tolist()
    assert (pt_["epoch"], pt_["tag"]) == (2, "x")


def test_bf16_round_trip_and_torn_shard(tmp_path):
    g = torch.Generator().manual_seed(3)
    w = torch.randn(5, 7, generator=g).bfloat16()
    ckpt.save_state_dict({"w": w, "m": w.float()}, str(tmp_path / "a"))
    got = {"w": torch.zeros(5, 7, dtype=torch.bfloat16),
           "m": torch.zeros(5, 7)}
    ckpt.load_state_dict(got, str(tmp_path / "a"))
    assert torch.equal(got["w"], w) and torch.equal(got["m"], w.float())
    # into an f32 target: the bf16 values, widened
    wide = {"w": torch.zeros(5, 7), "m": torch.zeros(5, 7)}
    ckpt.load_state_dict(wide, str(tmp_path / "a"))
    assert torch.equal(wide["w"], w.float())
    fault.set_fault_spec("torn_write@ckpt:1")
    ckpt.save_state_dict({"w": w}, str(tmp_path / "torn"))
    with pytest.raises(ckpt.CheckpointCorruptError, match="torn write"):
        ckpt.load_state_dict({"w": torch.zeros(5, 7, dtype=torch.bfloat16)},
                             str(tmp_path / "torn"))


def test_async_save_equals_sync(tmp_path):
    rng = np.random.RandomState(1)
    state = {"a": torch.from_numpy(rng.randn(64, 9).astype(np.float32)),
             "b": {"c": torch.arange(10), "d": torch.ones(3).bfloat16()},
             "n": 7}
    ckpt.save_state_dict(state, str(tmp_path / "sync"))
    h = ckpt.save_state_dict(state, str(tmp_path / "async"),
                             async_save=True)
    # the trainer may update its tensors in place right away
    state["a"].add_(1.0)
    assert h.wait(60)
    ckpt.verify_checkpoint(str(tmp_path / "async"))
    outs = []
    for d in ("sync", "async"):
        t = {"a": torch.zeros(64, 9),
             "b": {"c": torch.zeros(10, dtype=torch.int64),
                   "d": torch.zeros(3, dtype=torch.bfloat16)}, "n": 0}
        ckpt.load_state_dict(t, str(tmp_path / d))
        outs.append(t)
    assert torch.equal(outs[0]["a"], outs[1]["a"])
    assert torch.equal(outs[1]["a"] + 1.0, state["a"])
    assert torch.equal(outs[0]["b"]["c"], outs[1]["b"]["c"])
    assert torch.equal(outs[0]["b"]["d"], outs[1]["b"]["d"])
    assert outs[0]["n"] == outs[1]["n"] == 7


def test_torn_async_snapshot_is_never_committed(tmp_path, capfd):
    """A ``torn_write`` of an async snapshot models a writer killed
    mid-stream: its commit never runs, so LATEST keeps naming the step
    before it, and a load resumes there (as in JAX)."""
    lin = fault.CheckpointLineage(str(tmp_path), keep=3)
    w = torch.arange(4.0)
    lin.save({"w": w}, 1, async_save=True)
    fault.set_fault_spec("torn_write@ckpt:1")
    lin.save({"w": w * 2}, 2, async_save=True)
    lin.wait()
    assert lin.latest_committed() == 1
    target = {"w": torch.zeros(4)}
    assert lin.load_latest(target) == 1
    assert torch.equal(target["w"], w)
    assert [s for s, _ in lin.candidates()] == [1]


# ------------------------------------------------------------ resumable fit
def test_interrupted_fit_resumes_to_its_uninterrupted_twin(tmp_path, capsys):
    full = W.train(str(tmp_path / "full"))
    assert sorted(full) == list(range(12))
    first = W.train(str(tmp_path / "cut"), num_iters=7)
    second = W.train(str(tmp_path / "cut"))
    out = capsys.readouterr().out
    assert "RESUMED epoch=1 step=0 global_step=6" in out
    assert sorted(first) == list(range(7)) and sorted(second) == \
        list(range(6, 12))
    for g, v in {**first, **second}.items():
        assert abs(v - full[g]) < 1e-6, (g, v, full[g])


def _pair(seed=0):
    paddle.seed(seed)
    jnet = paddle.nn.Sequential(paddle.nn.Linear(16, 32), paddle.nn.ReLU(),
                                paddle.nn.Linear(32, 4))
    tnet = pt.nn.Sequential(pt.nn.Linear(16, 32, device="cpu"),
                            pt.nn.ReLU(), pt.nn.Linear(32, 4, device="cpu"))
    arrays = {n: np.asarray(t._data) for n, t in jnet.state_dict().items()}
    pt.params_from_paddle_tpu(arrays, tnet)
    # the optimizer names its state by the parameters' JAX names, so a
    # JAX snapshot's accumulators land on the same parameters
    names = {n: p.name for n, p in jnet.named_parameters()}
    for n, p in tnet.named_parameters():
        p.param_name = names[n]
    jm, tm = paddle.Model(jnet), pt.Model(tnet)
    jm.prepare(paddle.optimizer.AdamW(1e-2, parameters=jnet.parameters()),
               paddle.nn.MSELoss())
    tm.prepare(pt.AdamW(1e-2, parameters=tnet.parameters()),
               pt.nn.MSELoss())
    return jm, tm


class _JRec(jcb.Callback):
    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])


class _TRec(tcb.Callback):
    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])


def _ds(io):
    x = np.random.RandomState(42).randn(24, 16).astype("float32")
    y = x @ np.random.RandomState(7).randn(16, 4).astype("float32")

    class DS(io.Dataset):
        def __getitem__(self, i):
            return x[i], y[i]

        def __len__(self):
            return len(x)

    return DS()


def _fit(model, io, rec, root, **kw):
    model.fit(_ds(io), batch_size=4, epochs=2, verbose=0, shuffle=True,
              lineage=root, snapshot_interval=2, loss_fetch_every=1,
              callbacks=[rec], **kw)
    return rec.losses


def test_resumable_fit_losses_match_jax(tmp_path):
    jm, tm = _pair()
    jl = _fit(jm, jio, _JRec(), str(tmp_path / "j"))
    tl = _fit(tm, pt.io, _TRec(), str(tmp_path / "t"),
              async_snapshot=True, integrity=True)
    assert len(jl) == len(tl) == 12
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)


def test_jax_run_resumes_in_the_port(tmp_path, capsys):
    """A run started in the JAX package and cut after 5 steps resumes in
    the port from JAX's f32 snapshot (step 4) and continues with the
    losses of JAX's uninterrupted run."""
    jm, _ = _pair()
    ref = _fit(jm, jio, _JRec(), str(tmp_path / "ref"))
    jm, tm = _pair()
    _fit(jm, jio, _JRec(), str(tmp_path / "run"), num_iters=5)
    rest = _fit(tm, pt.io, _TRec(), str(tmp_path / "run"))
    assert "RESUMED epoch=0 step=4 global_step=4" in capsys.readouterr().out
    assert len(rest) == 8
    np.testing.assert_allclose(rest, ref[4:], rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------ the launcher
def _worker_env(monkeypatch, ckpt_dir, **extra):
    monkeypatch.setenv("PTT_CKPT_DIR", str(ckpt_dir))
    for k, v in extra.items():
        monkeypatch.setenv(k, str(v))


def _logs(log_dir, rank):
    text = ""
    for name in sorted(os.listdir(log_dir)):
        if name.startswith(f"workerlog.{rank}"):
            with open(os.path.join(log_dir, name)) as f:
                text += f.read()
    return text


def _losses(text):
    return {int(m.group(1)): float(m.group(2))
            for m in re.finditer(r"LOSS (\d+) ([\d.eE+-]+)", text)}


@pytest.fixture(scope="module")
def reference_losses(tmp_path_factory):
    """The worker's uninterrupted run, in this process."""
    threads, dev = torch.get_num_threads(), port_device.DEFAULT_DEVICE
    prev = signal.getsignal(signal.SIGTERM)
    torch.set_num_threads(1)
    port_device.DEFAULT_DEVICE = "cpu"
    try:
        return W.train(str(tmp_path_factory.mktemp("ref") / "ck"))
    finally:
        torch.set_num_threads(threads)
        port_device.DEFAULT_DEVICE = dev
        signal.signal(signal.SIGTERM, prev)


def test_launcher_crash_and_torn_snapshot(tmp_path, monkeypatch, capfd,
                                          reference_losses):
    """``crash@step:6`` with the step-4 snapshot torn (``ckpt`` hits: the
    baseline at 0, then 2, then 4; sync snapshots, so the torn one is
    committed): the launcher reports rc 43 and restarts, the lineage
    skips the torn snapshot by its CRC and resumes from step 2, and every
    loss equals the uninterrupted run's."""
    _worker_env(monkeypatch, tmp_path / "ck", PTT_SYNC_SNAPSHOTS=1)
    monkeypatch.setenv("PADDLE_TPU_FAULTS", "crash@step:6,torn_write@ckpt:3")
    log_dir = str(tmp_path / "logs")
    rc = launch(["--nproc_per_node", "1", "--max_restarts", "1",
                 "--log_dir", log_dir, WORKER])
    err = capfd.readouterr().err
    assert rc == 0, err
    assert "rc=43" in err and "restarting workers (1/1)" in err
    log = _logs(log_dir, 0)
    assert "skipping snapshot step_00000004" in log
    assert "RESUMED epoch=0 step=2 global_step=2" in log
    got = _losses(log)
    assert sorted(got) == sorted(reference_losses)
    for g, v in got.items():
        assert abs(v - reference_losses[g]) < 1e-6, (g, v)


def test_launcher_preemption_does_not_consume_restarts(
        tmp_path, monkeypatch, capfd, reference_losses):
    _worker_env(monkeypatch, tmp_path / "ck", PTT_PREEMPT_AT=3)
    log_dir = str(tmp_path / "logs")
    rc = launch(["--nproc_per_node", "1", "--max_restarts", "0",
                 "--log_dir", log_dir, WORKER])
    err = capfd.readouterr().err
    assert rc == 0, err
    assert "rc=75" in err and "does not consume max_restarts" in err
    log = _logs(log_dir, 0)
    assert "PREEMPT_SAVED 4" in log
    assert "RESUMED epoch=0 step=4 global_step=4" in log
    got = _losses(log)
    assert sorted(got) == sorted(reference_losses)
    for g, v in got.items():
        assert abs(v - reference_losses[g]) < 1e-6, (g, v)


def test_launcher_terminates_the_survivor_of_a_dead_peer(
        tmp_path, monkeypatch, capfd):
    """Two workers; rank 1 crashes at its 2nd step while rank 0 is slow:
    the launcher terminates rank 0 (SIGTERM: its graceful save) and,
    with no restarts left, exits with the crash's code."""
    _worker_env(monkeypatch, tmp_path / "ck", PTT_STEP_SLEEP=0.5)
    monkeypatch.setenv("PTT_CKPT_DIR", str(tmp_path / "ck"))
    monkeypatch.setenv("PADDLE_TPU_FAULTS", "crash@step:2%1")
    # each rank its own lineage: the worker keys it by its rank
    monkeypatch.setenv("PTT_CKPT_PER_RANK", "1")
    log_dir = str(tmp_path / "logs")
    rc = launch(["--nproc_per_node", "2", "--max_restarts", "0",
                 "--terminate_grace", "20", "--log_dir", log_dir, WORKER])
    err = capfd.readouterr().err
    assert rc == fault.EXIT_FAULT, err
    assert "terminating surviving workers (first failure rc=43)" in err
    survivor = _logs(log_dir, 0)
    assert "SIGTERM: graceful preemption requested" in survivor
    assert "DONE" not in survivor
    assert "DONE" not in _logs(log_dir, 1)


def test_a_hung_snapshot_write_trips_the_watchdog(tmp_path):
    """A snapshot's write hangs (``hang`` on a shard's submit): the loop's
    next wait for it (the next interval save, or ``finalize``) beats no
    heartbeat, so the step watchdog escalates as the JAX package's does
    and the worker exits ``EXIT_HANG`` instead of waiting forever."""
    import subprocess
    env = dict(os.environ, PTT_CKPT_DIR=str(tmp_path / "ck"),
               PADDLE_TPU_WATCHDOG_TIMEOUT="15",
               PADDLE_TPU_FAULTS="hang@ckpt_io:3",
               PADDLE_TPU_FAULT_HANG_S="240",
               PADDLE_TPU_WORKERLOG_DIR=str(tmp_path / "logs"))
    env.pop("PADDLE_TPU_FAULT_LEDGER", None)
    repo = os.path.dirname(os.path.dirname(WORKER))
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    r = subprocess.run([sys.executable, WORKER], env=env, cwd=repo,
                       capture_output=True, text=True, timeout=200)
    assert "injecting hang at site 'ckpt_io'" in r.stderr, r.stderr
    assert r.returncode == fault.EXIT_HANG == 19, r.stderr
    assert "escalation done" in r.stderr, r.stderr
    assert "DONE" not in r.stdout
