"""The port's control plane against ``paddle_tpu``'s on the CPU: the
``keyspace`` strings (equal, byte for byte), ``TCPStore`` set / get /
add / wait / barrier across two processes (a port client against a
port master), the flight recorder (a dump written by the port reads in
the JAX package to the same post-mortem text, and the blame rule is
JAX's), and the step watchdog, which trips and exits 19 in a child
process after dumping the ring, as the launcher's post-mortem reads it.
"""
import inspect
import json
import os
import subprocess
import sys
import textwrap

import pytest

from paddle_tpu.distributed import flight_recorder as jfr
from paddle_tpu.distributed import keyspace as jks

from paddle_tpu_torch.distributed import fault
from paddle_tpu_torch.distributed import flight_recorder as fr
from paddle_tpu_torch.distributed import keyspace as ks
from paddle_tpu_torch.distributed.tcp_store import (StoreTimeoutError,
                                                    TCPStore)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reset_recorders(monkeypatch):
    for var in ("PADDLE_TPU_FLIGHT_RECORDER", "PADDLE_TPU_WORKERLOG_DIR",
                "PADDLE_TPU_FR_DUMP_DIR", "PADDLE_TPU_FAULTS"):
        monkeypatch.delenv(var, raising=False)
    fr._reset_state()
    jfr._reset_state()
    yield
    fr._reset_state()
    jfr._reset_state()
    fault.set_fault_spec(None)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_keyspace_strings_equal_jax():
    names = sorted(n for n in dir(ks) if not n.startswith("_"))
    assert names == sorted(n for n in dir(jks) if not n.startswith("_"))
    for name in names:
        ours, theirs = getattr(ks, name), getattr(jks, name)
        if isinstance(ours, str):
            assert ours == theirs, name
        elif inspect.isfunction(ours):
            n = len(inspect.signature(ours).parameters)
            for args in (("job7",) * n, tuple(range(3, 3 + n))):
                assert ours(*args) == theirs(*args), name


def _run_child(code, env=None, timeout=120):
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=REPO,
        capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, **(env or {})))


def test_tcp_store_across_two_processes():
    port = _free_port()
    master = TCPStore("127.0.0.1", port, is_master=True, world_size=2,
                      timeout=60)
    try:
        master.set("greeting", b"hello")
        child = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(f"""
                from paddle_tpu_torch.distributed.tcp_store import TCPStore
                s = TCPStore("127.0.0.1", {port}, is_master=False,
                             world_size=2, timeout=60)
                assert s.get("greeting") == b"hello"
                assert s.add("counter", 5) in (5, 12)
                s.set("from_child", b"42")
                s.wait(["from_master"], timeout=30)
                assert s.get("from_master") == b"go"
                s.barrier("b1", 2, timeout=30)
                print("CHILD_OK", flush=True)
                """)], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        master.wait(["from_child"], timeout=60)
        assert master.get("from_child") == b"42"
        assert master.add("counter", 7) in (7, 12)
        assert master.check("counter") and not master.check("nope")
        master.set("from_master", b"go")
        master.barrier("b1", 2, timeout=60)
        out, err = child.communicate(timeout=60)
        assert child.returncode == 0, err
        assert "CHILD_OK" in out
        assert master.add("counter", 0) == 12
        with pytest.raises(StoreTimeoutError):
            master.get("never_set", timeout=0.2)
        assert master.delete_key("from_child") and \
            not master.check("from_child")
    finally:
        master.stop_server()


def _dumps(tmp_path, pkg):
    """Two ranks' dumps: rank 0 completed a barrier and then a step,
    rank 1 hangs inside the barrier it issued."""
    d = str(tmp_path / pkg.__name__.split(".")[0])
    for rank, hang in ((0, False), (1, True)):
        pkg._reset_state()
        rec = pkg.enable(capacity=8, rank=rank, world_size=2)
        pkg.note_step(3)
        e = pkg.record_issue("barrier", group="world", shape=[1],
                             dtype="int32", site="train.py:10")
        if not hang:
            pkg.record_complete(e)
            pkg.note_heartbeat()
        assert rec.rank == rank
        pkg.dump(reason="watchdog_timeout", dump_dir=d)
    return d


def test_flight_recorder_dump_reads_in_jax(tmp_path):
    d = _dumps(tmp_path, fr)
    ours = fr.collect_dumps(d)
    assert [x["rank"] for x in ours] == [0, 1]
    text = jfr.format_post_mortem(jfr.collect_dumps(d))
    assert text == fr.format_post_mortem(ours)
    # the JAX package's own dumps of the same events: the same text
    jd = _dumps(tmp_path, jfr)
    assert jfr.format_post_mortem(jfr.collect_dumps(jd)) == text
    assert "rank 1 [watchdog_timeout]: waiting inside barrier" in text
    assert "blame: rank 1 stalled before step seq=2, step 3" in text
    keys = set(json.load(open(fr.dump_path(d, 0))))
    assert keys == set(json.load(open(jfr.dump_path(jd, 0))))


def test_blame_rows_match_jax():
    rows = [{"rank": 0, "issued_seq": 9, "issued_kind": "allreduce",
             "completed_seq": 8, "step": 4},
            {"rank": 1, "issued_seq": 7, "issued_kind": "barrier",
             "completed_seq": 7, "step": 3},
            {"rank": 2, "issued_seq": 9, "issued_kind": "allreduce",
             "completed_seq": 8, "step": 4}]
    assert fr.blame_rows(rows) == jfr.blame_rows(rows)
    assert fr.blame_rows(rows)["rank"] == 1
    assert fr.blame_rows(rows[:1]) is None


def test_step_watchdog_trips_and_exits_19(tmp_path):
    """A staged step that hangs (``hang@step:4``) stops the heartbeats;
    the watchdog, armed after two steps (a first step's staging on a
    loaded CPU can outlast a short timeout), escalates: a
    flight-recorder dump naming the step, then ``EXIT_HANG``."""
    r = _run_child("""
        import torch
        import paddle_tpu_torch as pt
        from paddle_tpu_torch import device
        from paddle_tpu_torch.distributed import watchdog
        device.DEFAULT_DEVICE = "cpu"
        net = pt.nn.Linear(4, 2)
        opt = pt.SGD(0.1, parameters=net.parameters())
        def step(x):
            loss = net(x).sum()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        staged = pt.jit.to_static(step, capture=(net, opt))
        for i in range(6):
            if i == 2:
                watchdog.start_step_watchdog(6.0)
            staged(torch.ones(3, 4))
            print("STEP", i, flush=True)
        """, env={"PADDLE_TPU_FLIGHT_RECORDER": "16",
                  "PADDLE_TPU_FAULTS": "hang@step:4",
                  "PADDLE_TPU_WORKERLOG_DIR": str(tmp_path)})
    assert r.returncode == fault.EXIT_HANG == 19, r.stderr
    assert "STEP 2" in r.stdout and "STEP 3" not in r.stdout
    assert "escalation done" in r.stderr
    dumps = jfr.collect_dumps(str(tmp_path))
    assert len(dumps) == 1 and dumps[0]["reason"] == "watchdog_timeout"
    assert dumps[0]["step"] == 3
    assert "rank 0 [watchdog_timeout]: completed step" in \
        jfr.format_post_mortem(dumps)
