"""The port's elastic control plane on the CPU, JAX-free: twins of the
elastic cases of ``tests/test_elastic_tuner.py`` (the membership
registry), the ``--np MIN:MAX`` launcher cases of
``tests/test_fault_tolerance.py`` (scale-down, standby backfill,
scale-out, the hold below ``min_np``) and its node-level cases (usage
errors, the node fault kinds, the quarantine ledger, the failure-domain
map, round specs, the node registry, a two-agent rendezvous, an orphaned
agent fencing itself, quarantine strikes across a store re-home, the
coordinator roles). The chaos runs that JAX marks ``slow`` are twinned
with the same marker: ``tests/torch_elastic_worker.py`` under ``--np
2:3`` and ``--nnodes 2:3``, the store failover, the quarantine and the
coordinator takeover; their on-card counterpart is ``chip_smoke.py``'s
phase 31.

The launcher runs in this process (``launch(argv)``) over plain-Python
workers written by the tests, as JAX's fast cases do.
"""
import glob
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import pytest

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed import elastic
from paddle_tpu_torch.distributed import env as denv
from paddle_tpu_torch.distributed import fault
from paddle_tpu_torch.distributed import flight_recorder as flight
from paddle_tpu_torch.distributed import tcp_store
from paddle_tpu_torch.distributed import watchdog
from paddle_tpu_torch.distributed.launch import launch

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORKER = os.path.join(TESTS, "torch_elastic_worker.py")
MAIN = "paddle_tpu_torch.distributed.launch"


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _read_worker_logs(log_dir, rank):
    text = ""
    for p in sorted(glob.glob(os.path.join(log_dir, f"workerlog.{rank}*"))):
        with open(p) as f:
            text += f.read()
    return text


def _clean_env(extra=None):
    env = dict(os.environ)
    for k in list(env):
        if k.startswith(("PADDLE_TPU_", "PADDLE_TRAINER")):
            del env[k]
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p and p != REPO])
    env.update(extra or {})
    return env


@pytest.fixture(autouse=True)
def _reset_process_state(monkeypatch):
    """No fault spec, ledger, preemption flag, flight recorder, watchdog,
    elastic registration or process group leaks into or out of a case."""
    for var in ("PADDLE_TPU_FAULTS", "PADDLE_TPU_FAULT_LEDGER",
                "PADDLE_TPU_WATCHDOG_TIMEOUT", "PADDLE_TPU_ELASTIC_JOB_ID"):
        monkeypatch.delenv(var, raising=False)

    def reset():
        fault.set_fault_spec(None)
        fault._preempt_event.clear()
        flight._reset_state()
        tcp_store._reset_replication_state()
        watchdog.stop_step_watchdog()
        watchdog._disabled = False
        elastic._env_worker = None
        import torch.distributed as tdist
        if tdist.is_initialized():
            tdist.destroy_process_group()
        denv._initialized = False

    reset()
    yield
    reset()


# ------------------------------------------------- the membership registry
def test_heartbeat_expiry_is_a_scale_down_event():
    port = _free_port()
    mgr = dist.ElasticManager("hb", np="1:3", port=port, is_master=True,
                              ttl=1.0)
    w1 = dist.ElasticManager("hb", np="1:3", port=port, ttl=1.0)
    w2 = dist.ElasticManager("hb", np="1:3", port=port, ttl=1.0)
    n1 = w1.register("hb-w1")
    n2 = w2.register("hb-w2")
    mgr.announce([n1, n2])
    assert set(mgr.hosts()) == {"hb-w1", "hb-w2"}
    w2._stop.set()  # host lost: heartbeats stop, timestamp left stale
    status = mgr.watch(interval=0.2, max_wait=8.0)
    assert status == dist.ElasticStatus.RESTART
    assert mgr.hosts() == ["hb-w1"]  # expiry, not deregistration
    w1.deregister()


def test_all_hearts_stopped_below_min_np_exits():
    port = _free_port()
    mgr = dist.ElasticManager("hbx", np="2:2", port=port, is_master=True,
                              ttl=0.8)
    w1 = dist.ElasticManager("hbx", np="2:2", port=port, ttl=0.8)
    w2 = dist.ElasticManager("hbx", np="2:2", port=port, ttl=0.8)
    mgr.announce([w1.register("x-w1"), w2.register("x-w2")])
    w1._stop.set()
    w2._stop.set()
    assert mgr.watch(interval=0.2, max_wait=10.0) == \
        dist.ElasticStatus.EXIT


def test_join_inside_range_triggers_restart_and_new_joins():
    port = _free_port()
    mgr = dist.ElasticManager("join", np="1:3", port=port, is_master=True,
                              ttl=2.0)
    w1 = dist.ElasticManager("join", np="1:3", port=port, ttl=2.0)
    n1 = w1.register("j-w1")
    mgr.announce([n1])
    assert mgr.new_joins([n1]) == []
    w2 = dist.ElasticManager("join", np="1:3", port=port, ttl=2.0)
    w2.register("j-w2")
    assert mgr.new_joins([n1]) == ["j-w2"]
    assert set(mgr.joined_names()) == {"j-w1", "j-w2"}
    assert mgr.watch(interval=0.2, max_wait=5.0) == \
        dist.ElasticStatus.RESTART
    w1.deregister()
    w2.deregister()


def test_dead_master_watch_reports_error(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_STORE_CONNECT_DEADLINE", "0.3")
    port = _free_port()
    master = dist.TCPStore("127.0.0.1", port, is_master=True, timeout=5)
    w = dist.ElasticManager("dead", np="1:2", port=port, ttl=1.0, timeout=5)
    n = w.register("d-w1")
    w.announce([n])
    assert w.hosts() == [n]
    w._stop.set()  # silence the beat thread before the store goes away
    master._lib.pd_store_server_stop(master._server)
    master._server = None
    t0 = time.time()
    assert w.watch(interval=0.2, max_wait=30.0) == \
        dist.ElasticStatus.ERROR
    assert time.time() - t0 < 25  # bounded, not the full max_wait spin


def test_elastic_membership_and_scale_event():
    port = _free_port()
    mgr = dist.ElasticManager("job1", np="1:3", port=port, is_master=True,
                              ttl=1.5)
    w1 = dist.ElasticManager("job1", np="1:3", port=port, ttl=1.5)
    n1 = w1.register("worker1")
    mgr.announce([n1])
    assert mgr.hosts() == ["worker1"]
    w2 = dist.ElasticManager("job1", np="1:3", port=port, ttl=1.5)
    n2 = w2.register("worker2")
    mgr.announce([n1, n2])
    assert set(mgr.hosts()) == {"worker1", "worker2"}
    w2.deregister()
    assert mgr.watch(interval=0.2, max_wait=5.0) == \
        dist.ElasticStatus.RESTART
    mgr.complete()
    assert mgr.watch(interval=0.1, max_wait=2.0) == \
        dist.ElasticStatus.COMPLETED
    w1.deregister()


def test_init_parallel_env_registers_an_elastic_worker(monkeypatch):
    """An elastic worker registers with the launcher's registry from
    ``init_parallel_env``, before any process group (JAX's order,
    ``paddle_tpu/distributed/env.py:33-41``); without a coordinator the
    world is this one process."""
    port = _free_port()
    mgr = dist.ElasticManager("envjob", np="1:2", port=port, is_master=True,
                              ttl=5.0)
    monkeypatch.setenv("PADDLE_TPU_ELASTIC_JOB_ID", "envjob")
    monkeypatch.setenv("PADDLE_TPU_ELASTIC_STORE", f"127.0.0.1:{port}")
    monkeypatch.setenv("PADDLE_TPU_ELASTIC_NP", "1:2")
    monkeypatch.setenv("PADDLE_TPU_ELASTIC_NAME", "env-w0")
    monkeypatch.delenv("PADDLE_TPU_COORDINATOR", raising=False)
    assert not dist.is_initialized()
    assert dist.init_parallel_env() is None
    assert dist.is_initialized()
    assert (dist.get_rank(), dist.get_world_size()) == (0, 1)
    assert mgr.hosts() == ["env-w0"]
    elastic._env_worker._stop.set()


# ------------------------------------------------- the --np launcher (fast)
def _elastic_script(tmp_path):
    """Plain-python elastic worker: prints its rendezvous env, optionally
    exits nonzero / sleeps per round and rank."""
    script = tmp_path / "ew.py"
    script.write_text(
        "import os, sys, time\n"
        "rank = os.environ['PADDLE_TPU_PROCESS_ID']\n"
        "world = os.environ['PADDLE_TRAINERS_NUM']\n"
        "rnd = os.environ['PADDLE_TPU_RESTART_NUM']\n"
        "print('ENV', rnd, rank, world,\n"
        "      os.environ.get('PADDLE_TPU_ELASTIC_NAME'),\n"
        "      os.environ.get('PADDLE_TPU_ELASTIC_STORE'), flush=True)\n"
        "mode = os.environ.get('EW_MODE', '')\n"
        "if rnd == '0' and mode in ('lose_rank1', 'join_flow') "
        "and rank == '1':\n"
        "    sys.exit(7)\n"
        "if rnd == '0' and mode == 'lose_all':\n"
        "    sys.exit(9)\n"
        "if rnd == '0' and mode == 'standby_flow' and rank == '1':\n"
        "    time.sleep(6)\n"
        "    sys.exit(7)\n"
        "if rnd == '0' or (rnd == '1' and mode == 'join_flow'):\n"
        "    time.sleep(60)\n"
        "sys.exit(0)\n")
    return str(script)


def _launch_np(tmp_path, np_spec, mode, eport=None, extra_argv=()):
    os.environ["EW_MODE"] = mode
    try:
        return launch(["--np", np_spec,
                       "--master", f"127.0.0.1:{_free_port()}",
                       "--elastic_port", str(eport or _free_port()),
                       "--terminate_grace", "1",
                       "--log_dir", str(tmp_path / "logs"),
                       *extra_argv, _elastic_script(tmp_path)])
    finally:
        os.environ.pop("EW_MODE", None)


def test_elastic_launcher_scale_down_relaunches_smaller(tmp_path, capfd):
    """Losing one worker of two inside [1,2] is a scale event: survivors
    torn down, relaunch at world_size=1 with re-rendered env."""
    assert _launch_np(tmp_path, "1:2", "lose_rank1") == 0
    err = capfd.readouterr().err
    assert "scale event" in err and "world_size=1" in err
    assert "does not consume max_restarts" in err
    round0 = _read_worker_logs(str(tmp_path / "logs"), 0)
    assert "ENV 0 0 2 r0-w0" in round0
    assert "ENV 1 0 1 r1-w0" in round0


def _joiner(eport, np_spec, names, delay, done):
    def run():
        time.sleep(delay)
        ems = []
        for n in names:
            em = dist.ElasticManager("default", np_spec, port=eport,
                                     ttl=10.0)
            em.register(n)
            ems.append(em)
        done.wait(timeout=30)
        for em in ems:
            # stop beating; the launcher's registry is gone with the job
            em._stop.set()
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def test_elastic_launcher_standby_join_backfills_loss(tmp_path, capfd):
    """A join at max_np is held as standby, and backfills a later loss:
    the relaunch stays at world 2."""
    eport, done = _free_port(), threading.Event()
    t = _joiner(eport, "1:2", ["standby-0"], 2.0, done)
    try:
        rc = _launch_np(tmp_path, "1:2", "standby_flow", eport)
    finally:
        done.set()
    t.join(timeout=15)
    assert rc == 0
    err = capfd.readouterr().err
    assert "held as standby" in err
    assert "relaunching at world_size=2" in err
    assert "world_size=1" not in err
    assert "ENV 1 1 2" in _read_worker_logs(str(tmp_path / "logs"), 1)


def test_elastic_launcher_join_scales_out(tmp_path, capfd):
    """After a scale-down to 1, a node joining the rendezvous widens the
    world back to 2."""
    eport, done = _free_port(), threading.Event()
    t = _joiner(eport, "1:2", ["ext-0"], 4.0, done)
    try:
        rc = _launch_np(tmp_path, "1:2", "join_flow", eport)
    finally:
        done.set()
    t.join(timeout=15)
    assert rc == 0
    err = capfd.readouterr().err
    assert "scale event" in err
    assert "node join" in err
    assert "relaunching" in err and "world_size=2" in err.split(
        "node join")[1]
    assert "ENV 2 1 2" in _read_worker_logs(str(tmp_path / "logs"), 1)


def test_elastic_launcher_holds_below_min_for_joins(tmp_path, capfd):
    """Below min_np the launcher holds for joiners; two registrations
    bring the world back to min_np."""
    eport, done = _free_port(), threading.Event()
    t = _joiner(eport, "2:2", ["hold-ext-0", "hold-ext-1"], 2.5, done)
    try:
        rc = _launch_np(tmp_path, "2:2", "lose_all", eport,
                        ("--elastic_timeout", "15"))
    finally:
        done.set()
    t.join(timeout=15)
    assert rc == 0
    err = capfd.readouterr().err
    assert "HOLD" in err
    assert "relaunching at world_size=2" in err
    assert "ENV 1 0 2" in _read_worker_logs(str(tmp_path / "logs"), 0)


@pytest.mark.slow
def test_elastic_chaos_sigkill_scales_down_and_resumes(tmp_path):
    """SIGKILL one worker of a three-worker elastic job (``Model.fit``
    under ``DataParallel`` with a ``CheckpointLineage``, ``--np 2:3``):
    the launcher relaunches at world 2, and both survivors resume at the
    exact epoch/step of the last committed snapshot and finish."""
    log_dir = str(tmp_path / "logs")
    env = _clean_env({
        "PADDLE_TPU_CKPT_DIR": str(tmp_path / "ck_elastic"),
        "PADDLE_TPU_FT_STORE_PORT": str(_free_port()),
        "PADDLE_TPU_FT_EPOCHS": "2",
        "PADDLE_TPU_FT_BATCHES": "9",
        "PADDLE_TPU_FT_INTERVAL": "1",
        "PADDLE_TPU_ELASTIC_KILL": "2:2",
    })
    r = subprocess.run(
        [sys.executable, "-m", MAIN, "--np", "2:3",
         "--master", f"127.0.0.1:{_free_port()}",
         "--elastic_port", str(_free_port()),
         "--terminate_grace", "5", "--log_dir", log_dir, WORKER],
        env=env, capture_output=True, text=True, timeout=600, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "scale event" in r.stderr
    assert "relaunching at world_size=2" in r.stderr
    k = _read_worker_logs(log_dir, 2)
    assert "WORLD 3" in k and "SELF_SIGKILL" in k
    for rank in (0, 1):
        log = _read_worker_logs(log_dir, rank)
        assert "WORLD 3" in log and "WORLD 2" in log
        m = re.search(r"RESUMED epoch=(\d+) step=(\d+) global_step=(\d+)",
                      log)
        assert m, f"rank {rank} never resumed:\n{log}"
        e, s, _ = (int(x) for x in m.groups())
        round1 = log.split("WORLD 2", 1)[1]
        batches = [tuple(int(x) for x in bm.groups())
                   for bm in re.finditer(r"BATCH (\d+) (\d+) (\d+)",
                                         round1)]
        assert batches and (batches[0][0], batches[0][1]) == (e, s)
        assert "DONE" in round1
        assert any(b[0] == 1 for b in batches)


# ------------------------------------------------- node level: the parts
def test_nnodes_np_combination_fails_with_mapped_cause(tmp_path, capfd):
    log_dir = tmp_path / "logs"
    rc = launch(["--np", "1:2", "--nnodes", "2",
                 "--log_dir", str(log_dir), "script.py"])
    assert rc == fault.EXIT_USAGE == 64
    err = capfd.readouterr().err
    assert "rc=64: launcher usage error" in err
    assert "hint:" in err and "--nnodes MIN:MAX" in err
    assert log_dir.is_dir()
    rc = launch(["--nnodes", "two", "--log_dir", str(log_dir), "script.py"])
    assert rc == fault.EXIT_USAGE
    assert "not 'N' or 'MIN:MAX'" in capfd.readouterr().err
    assert "usage" in fault.describe_exit(64)


def test_node_fault_kinds_grammar():
    es = fault.parse_fault_spec(
        "node_die@node_beat:3%2,agent_stall@node_beat:1,"
        "store_die@elastic_store:5")
    assert [e.key() for e in es] == [
        "node_die@node_beat:3%2", "agent_stall@node_beat:1",
        "store_die@elastic_store:5"]
    for bad in ("node_die@step:1", "store_die@store:1",
                "agent_stall@ckpt:1"):
        with pytest.raises(ValueError):
            fault.parse_fault_spec(bad)
    fault.set_fault_spec("node_die:1")
    assert fault.maybe_inject("step") is None
    assert fault.maybe_inject("store") is None
    assert fault.maybe_inject("node_beat") == "node_die"
    fault.set_fault_spec("store_die:1")
    assert fault.maybe_inject("node_beat") is None
    assert fault.maybe_inject("elastic_store") == "store_die"


def test_agent_stall_sleeps_at_node_beat(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FAULT_AGENT_STALL_S", "0.3")
    fault.set_fault_spec("agent_stall@node_beat:1")
    t0 = time.monotonic()
    assert fault.maybe_inject("node_beat") is None
    assert time.monotonic() - t0 >= 0.3


def test_quarantine_list_sliding_window():
    q = dist.QuarantineList(window_s=10, threshold=2)
    assert not q.record_failure("n1", now=0.0)
    assert q.record_failure("n1", now=3.0)
    assert q.is_quarantined("n1") and q.hits == 1
    assert not q.record_failure("n1", now=4.0)
    assert not q.record_failure("n2", now=0.0)
    assert not q.record_failure("n2", now=20.0)
    assert q.record_failure("n2", now=25.0)
    assert q.quarantined() == ["n1", "n2"] and q.hits == 2


def test_failure_domain_map_describes_blast_radius():
    """``topology.FailureDomainMap``, the class the coordinator logs a
    lost node's domains with (the rest of ``topology`` is ROADMAP Queue 1
    item 8)."""
    import importlib
    main = importlib.import_module(MAIN + ".main")
    assert main.FailureDomainMap is dist.FailureDomainMap
    dm = dist.FailureDomainMap(["node0", "node1", "node2", "node3"],
                               dcn_group=2)
    assert dm.nodes == ["node0", "node1", "node2", "node3"]
    assert dm.ici_domain("node2") == 2 and dm.dcn_domain("node2") == 1
    assert dm.nodes_in_dcn(0) == ["node0", "node1"]
    assert dm.correlated("node2") == ["node3"]
    assert "shares a DCN link with node3" in dm.describe("node2")


def test_render_node_round_assigns_ranks_in_join_order():
    spec = dist.render_node_round(["b", "a"], 2, "127.0.0.1:8476",
                                  quarantined=["c"], store_inc=1)
    assert spec["nodes"] == {"b": 0, "a": 1}
    assert spec["world"] == 4 and spec["nproc"] == 2
    assert spec["quarantined"] == ["c"] and spec["store_inc"] == 1


def test_node_registry_membership_and_rounds():
    port = _free_port()
    master = dist.TCPStore("127.0.0.1", port, is_master=True, timeout=15)
    reg = dist.NodeRegistry(master, "jobx", ttl=2.0)
    reg.register("nodeA", {"ord": 0, "status": "idle", "round": 0})
    reg.register("nodeB", {"ord": 1, "status": "idle", "round": 0})
    assert reg.joined() == ["nodeA", "nodeB"]
    assert set(reg.live()) == {"nodeA", "nodeB"}
    assert reg.record("nodeA")["ord"] == 0
    assert reg.record("nodeC") is None
    no = reg.publish_round({"nodes": {"nodeA": 0, "nodeB": 1},
                            "nproc": 2, "world": 4, "master": "x:1"})
    assert no == 1 and reg.round_no() == 1
    assert reg.round(1)["world"] == 4
    reg.beat("nodeB", {"ord": 1, "status": "running", "round": 1})
    assert reg.live(now=time.time() + 3.0) == {}
    assert not reg.is_complete()
    reg.announce_complete()
    assert reg.is_complete()


def test_quarantine_hits_survive_midwindow_rehome():
    """Quarantine strikes written through the replicated registry survive
    a mid-window primary death."""
    p1, p2 = _free_port(), _free_port()
    prim = dist.TCPStore("127.0.0.1", p1, is_master=True, timeout=15)
    standby = dist.TCPStore("127.0.0.1", p2, is_master=True, timeout=15)
    fs = dist.FailoverStore(f"127.0.0.1:{p1},127.0.0.1:{p2}", timeout=15,
                            connect_deadline=2.0)
    q = dist.QuarantineList(window_s=300.0, threshold=2)
    q.record_failure("flaky", now=100.0)
    fs.set("elastic/j/quarantine", json.dumps(q.to_dict(now=120.0)))
    sh = dist.LogShipper(f"127.0.0.1:{p1}", f"127.0.0.1:{p2}", timeout=15)
    while sh.ship_once():
        pass
    prim.stop_server()
    restored = dist.QuarantineList().restore(
        json.loads(fs.get("elastic/j/quarantine")), now=5000.0)
    assert fs.incarnation == 1
    assert restored.record_failure("flaky", now=5100.0) is True
    assert restored.quarantined() == ["flaky"]
    standby.stop_server()


def test_quarantine_ledger_checkpoint_roundtrip():
    q = dist.QuarantineList(window_s=300.0, threshold=2)
    q.record_failure("flaky", now=100.0)
    q.record_failure("flaky", now=110.0)
    q.record_failure("wobbly", now=115.0)
    assert q.is_quarantined("flaky") and q.hits == 1
    state = q.to_dict(now=120.0)
    shadow = dist.QuarantineList().restore(state, now=5000.0)
    assert shadow.quarantined() == ["flaky"] and shadow.hits == 1
    assert shadow.window_s == 300.0 and shadow.threshold == 2
    assert shadow.record_failure("wobbly", now=5100.0) is True
    assert shadow.quarantined() == ["flaky", "wobbly"]
    fresh = dist.QuarantineList().restore(state, now=5000.0)
    assert fresh.record_failure("wobbly", now=5500.0) is False


def test_coordinator_role_usage_errors(tmp_path, capfd):
    script = tmp_path / "w.py"
    script.write_text("print('hi')\n")
    rc = launch(["--np", "1", "--coordinator_role", "shadow",
                 "--master", f"127.0.0.1:{_free_port()}",
                 "--log_dir", str(tmp_path / "l1"), str(script)])
    assert rc == fault.EXIT_USAGE
    rc = launch(["--nnodes", "2:2", "--coordinator_role", "primary",
                 "--master", f"127.0.0.1:{_free_port()}",
                 "--log_dir", str(tmp_path / "l2"), str(script)])
    assert rc == fault.EXIT_USAGE
    err = capfd.readouterr().err
    assert "only applies to --nnodes" in err
    assert "needs a standby --master candidate" in err


# -------------------------------------- node level: coordinator and agents
def _node_script(tmp_path):
    script = tmp_path / "nw.py"
    script.write_text(
        "import os, sys, time\n"
        "rnd = int(os.environ.get('PADDLE_TPU_RESTART_NUM', '0'))\n"
        "nid = os.environ.get('PADDLE_TPU_NODE_ID')\n"
        "print('NW', rnd, os.environ['PADDLE_TPU_PROCESS_ID'],\n"
        "      os.environ['PADDLE_TRAINERS_NUM'], nid,\n"
        "      os.environ.get('PADDLE_TPU_NODE_RANK'),\n"
        "      os.environ.get('PADDLE_TPU_NNODES'), flush=True)\n"
        "mode = os.environ.get('NW_MODE', '')\n"
        "if mode == 'crash_node1' and nid == 'node1' and rnd < 2:\n"
        "    time.sleep(1.5)\n"
        "    sys.exit(43)\n"
        "if mode == 'sleep':\n"
        "    time.sleep(float(os.environ.get('NW_SLEEP', '8')))\n"
        "print('NW_DONE', flush=True)\n"
        "sys.exit(0)\n")
    return str(script)


def _launch_nodes(tmp_path, nnodes, nproc, extra_argv=(), env=None,
                  standby=False):
    master = f"127.0.0.1:{_free_port()}"
    if standby:
        master += f",127.0.0.1:{_free_port()}"
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        return launch(["--nnodes", nnodes, "--nproc_per_node", str(nproc),
                       "--master", master,
                       "--elastic_ttl", "2", "--terminate_grace", "2",
                       "--log_dir", str(tmp_path / "logs"),
                       *extra_argv, _node_script(tmp_path)])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _agent_log(tmp_path, node_id):
    with open(os.path.join(str(tmp_path / "logs"),
                           f"agentlog.{node_id}")) as f:
        return f.read()


def test_node_rendezvous_rerenders_ranks_across_agents(tmp_path, capfd):
    """Two local agents (``python -m paddle_tpu_torch.distributed.launch.
    node_agent``) of two workers each: every worker sees the
    coordinator's re-rendered world size, global rank and node rank."""
    assert _launch_nodes(tmp_path, "2:2", 2) == 0
    err = capfd.readouterr().err
    assert "round 1: nnodes=2 world_size=4" in err
    assert "all 2 node(s) finished" in err
    seen = {}
    for grank in range(4):
        log = _read_worker_logs(str(tmp_path / "logs"), grank)
        m = re.search(r"NW 0 (\d+) (\d+) (node\d) (\d) 2", log)
        assert m, f"rank {grank} env not rendered:\n{log}"
        assert int(m.group(1)) == grank and m.group(2) == "4"
        seen.setdefault(m.group(3), []).append(grank)
    assert sorted(len(v) for v in seen.values()) == [2, 2]
    for nid, ranks in seen.items():
        a = _agent_log(tmp_path, nid)
        assert "REGISTERED" in a and "ROUND 1 world=4" in a
        assert f"ranks={min(ranks)}-{max(ranks)}" in a
        assert "NODE_DONE" in a and "AGENT_EXIT 0" in a


def test_node_agent_fences_itself_when_orphaned(tmp_path):
    """An agent whose registry is gone for good fences itself: it tears
    down its workers and exits 3 with AGENT_ORPHANED."""
    port = _free_port()
    master = dist.TCPStore("127.0.0.1", port, is_master=True, timeout=15)
    script = tmp_path / "w.py"
    script.write_text("import time\ntime.sleep(60)\n")
    env = _clean_env({
        "PADDLE_TPU_AGENT_ORPHAN_S": "4",
        "PADDLE_TPU_STORE_FAILOVER_DEADLINE": "2",
        "PADDLE_TPU_STORE_PROBE_DEADLINE": "1",
    })
    proc = subprocess.Popen(
        [sys.executable, "-m", MAIN + ".node_agent",
         "--node_id", "lone", "--store", f"127.0.0.1:{port}",
         "--ttl", "2", "--terminate_grace", "1",
         "--log_dir", str(tmp_path / "logs"), str(script)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=REPO)
    try:
        deadline = time.time() + 60
        while time.time() < deadline:
            if master.check("elastic/default/node/r/lone"):
                break
            time.sleep(0.2)
        assert master.check("elastic/default/node/r/lone"), "never joined"
        master.stop_server()
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 3, out
    assert "AGENT_ORPHANED" in out
    assert "registry poll failed" in out


@pytest.mark.slow
def test_node_store_failover_training_continues(tmp_path, capfd,
                                                monkeypatch):
    """The primary registry master dies mid-round; every agent re-homes
    to the standby and the round runs on to the end."""
    monkeypatch.setenv("PADDLE_TPU_STORE_FAILOVER_DEADLINE", "15")
    monkeypatch.setenv("PADDLE_TPU_STORE_PROBE_DEADLINE", "2")
    fault.set_fault_spec("store_die@elastic_store:12")
    rc = _launch_nodes(tmp_path, "2:2", 1, standby=True,
                       env={"NW_MODE": "sleep", "NW_SLEEP": "10"})
    assert rc == 0
    err = capfd.readouterr().err
    assert "injected store_die" in err
    assert "re-homed to standby" in err
    assert "store incarnation 1" in err
    assert "all 2 node(s) finished" in err
    assert "preserved by replication" in err
    for nid in ("node0", "node1"):
        a = _agent_log(tmp_path, nid)
        assert "STORE_FAILOVER 1" in a and "NODE_DONE" in a
    assert "round 2" not in err
    assert glob.glob(os.path.join(str(tmp_path / "logs"),
                                  "workerlog.*.restart*")) == []
    for grank in range(2):
        assert "NW_DONE" in _read_worker_logs(str(tmp_path / "logs"),
                                              grank)


@pytest.mark.slow
def test_node_quarantine_after_two_failures_in_window(tmp_path, capfd):
    rc = _launch_nodes(
        tmp_path, "1:2", 1,
        extra_argv=("--quarantine_window", "120",
                    "--quarantine_threshold", "2"),
        env={"NW_MODE": "crash_node1"})
    assert rc == 0
    err = capfd.readouterr().err
    assert "quarantine node=node1" in err
    assert "quarantine_hits=1" in err
    assert re.search(r"round 3: nnodes=1 world_size=1 nodes=\['node0'\]",
                     err)
    assert "all 1 node(s) finished" in err
    a1 = _agent_log(tmp_path, "node1")
    assert a1.count("NODE_FAILED") == 2 and "QUARANTINED 3" in a1
    assert "NODE_DONE" in _agent_log(tmp_path, "node0")


@pytest.mark.slow
def test_node_sigkill_chaos_relaunches_and_resumes_resharded(tmp_path):
    """A 3-node x 2-worker job (``--nnodes 2:3``) loses a whole node to
    SIGKILL mid-epoch: the survivors relaunch at world 4 and resume at
    the exact epoch/step, resharded 6 -> 4."""
    log_dir = str(tmp_path / "logs")
    env = _clean_env({
        "PADDLE_TPU_CKPT_DIR": str(tmp_path / "ck_node"),
        "PADDLE_TPU_FT_STORE_PORT": str(_free_port()),
        "PADDLE_TPU_FT_EPOCHS": "2",
        "PADDLE_TPU_FT_BATCHES": "18",
        "PADDLE_TPU_FT_INTERVAL": "1",
        "PADDLE_TPU_ELASTIC_KILL": "4:2",
        "PADDLE_TPU_NODE_DIE_WITH_RANK": "4",
    })
    r = subprocess.run(
        [sys.executable, "-m", MAIN, "--nnodes", "2:3",
         "--nproc_per_node", "2", "--master", f"127.0.0.1:{_free_port()}",
         "--elastic_ttl", "3", "--terminate_grace", "5",
         "--elastic_timeout", "120", "--log_dir", log_dir, WORKER],
        env=env, capture_output=True, text=True, timeout=600, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    assert "node loss detected" in r.stderr
    assert re.search(r"round 2: nnodes=2 world_size=4", r.stderr), r.stderr
    agents = ""
    for p in glob.glob(os.path.join(log_dir, "agentlog.*")):
        with open(p) as f:
            agents += f.read()
    assert "NODE_DIE" in agents
    k = _read_worker_logs(log_dir, 4)
    assert "WORLD 6" in k and "SELF_SIGKILL" in k
    for rank in range(4):
        log = _read_worker_logs(log_dir, rank)
        assert "WORLD 6" in log and "WORLD 4" in log, f"rank {rank}"
        m = re.search(r"RESUMED epoch=(\d+) step=(\d+) global_step=(\d+)",
                      log)
        assert m, f"rank {rank} never resumed:\n{log[-2000:]}"
        e, s, _ = (int(x) for x in m.groups())
        assert "RESUMED_RESHARDED world=6->4" in log
        round1 = log.split("WORLD 4", 1)[1]
        batches = [tuple(int(x) for x in bm.groups())
                   for bm in re.finditer(r"BATCH (\d+) (\d+) (\d+)",
                                         round1)]
        assert batches and (batches[0][0], batches[0][1]) == (e, s)
        assert "DONE" in round1


@pytest.mark.slow
def test_coordinator_die_shadow_adopts_without_relaunch(tmp_path):
    """The primary coordinator is SIGKILLed mid-round; the shadow adopts
    the published round and supervises it to the end, with no
    re-rendezvous and no worker relaunch."""
    script = _node_script(tmp_path)
    p1, p2 = _free_port(), _free_port()
    master = f"127.0.0.1:{p1},127.0.0.1:{p2}"
    log_dir = str(tmp_path / "logs")
    env = _clean_env({
        "PADDLE_TPU_STORE_FAILOVER_DEADLINE": "10",
        "PADDLE_TPU_STORE_PROBE_DEADLINE": "1",
        "NW_MODE": "sleep", "NW_SLEEP": "18",
    })
    prim_env = dict(env, PADDLE_TPU_FAULTS="coordinator_die@coord_beat:10")
    base = [sys.executable, "-m", MAIN, "--nnodes", "2:2",
            "--nproc_per_node", "1", "--master", master,
            "--elastic_ttl", "2", "--terminate_grace", "2",
            "--log_dir", log_dir]
    shadow = subprocess.Popen(
        base + ["--coordinator_role", "shadow", "--local_agents", "0",
                script],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=REPO)
    prim = None
    try:
        time.sleep(1.0)
        prim = subprocess.Popen(
            base + ["--coordinator_role", "primary", "--local_agents",
                    "2", script],
            env=prim_env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, cwd=REPO)
        pout, _ = prim.communicate(timeout=120)
        sout, _ = shadow.communicate(timeout=180)
    finally:
        for p in (shadow, prim):
            if p is not None and p.poll() is None:
                p.kill()
    assert prim.returncode == -signal.SIGKILL, pout[-2000:]
    die = re.search(r"COORDINATOR_DIE ([\d.]+)", pout)
    assert die, pout[-2000:]
    assert shadow.returncode == 0, sout[-3000:]
    adopt = re.search(r"SHADOW_ADOPTED round=1 term=(\d+) wall=([\d.]+)",
                      sout)
    assert adopt, sout[-3000:]
    assert 0 < float(adopt.group(2)) - float(die.group(1)) < 60
    assert "resuming supervision of live agents without re-rendezvous" \
        in sout
    assert "all 2 node(s) finished" in sout
    assert "round 2" not in sout and "round 2" not in pout
    assert glob.glob(os.path.join(log_dir, "workerlog.*.restart*")) == []
    for grank in range(2):
        assert "NW_DONE" in _read_worker_logs(log_dir, grank)
    for nid in ("node0", "node1"):
        assert "AGENT_ORPHANED" not in _agent_log(tmp_path, nid)
