"""Per-node elastic agent — the node half of multi-host elastic training:
the port's copy of ``paddle_tpu/distributed/launch/node_agent.py``.

Reference capability: torchelastic's per-host agent / the fleet elastic
manager's node daemons. One agent runs on every host of a
``--nnodes MIN:MAX`` job (``python -m paddle_tpu_torch.distributed.launch.
node_agent``; the coordinator spawns them locally for the single-machine
pod simulation). The agent:

- registers its node into the coordinator's rendezvous registry
  (:class:`~paddle_tpu_torch.distributed.elastic.NodeRegistry` over a
  :class:`~paddle_tpu_torch.distributed.tcp_store.FailoverStore`) and
  heartbeats a node-scoped JSON record (node id, host, round, per-worker
  statuses) every ttl/3 — workers never talk to the registry themselves,
  so a 256-host pod costs 256 heartbeat streams, not 256×nproc;
- polls the registry for *round specs* the coordinator publishes and
  applies only the NEWEST one: tear down the current workers (SIGTERM
  graceful-save window, then SIGKILL) and relaunch with re-rendered
  ``PADDLE_TRAINERS_NUM`` / ranks / node_rank. An agent that missed
  rounds (stalled, partitioned) jumps straight to the latest spec — a
  zombie node fences its own stale workers instead of corrupting the new
  world;
- supervises the local workers: first real failure terminates local
  survivors and the node record turns ``failed`` (with rcs) so the
  coordinator reacts faster than heartbeat expiry; all-zero is ``done``;
  exit 75 everywhere is ``preempted``;
- survives registry-master death: the FailoverStore re-homes to the
  standby candidate with Backoff and the agent re-registers under the
  bumped store incarnation;
- enacts the node-scoped chaos kinds at its heartbeat site
  (``node_beat``): ``node_die`` = whole-node SIGKILL (self + every local
  worker — sudden host loss), ``agent_stall`` = heartbeats stop while
  workers keep running (the coordinator must declare the node lost and
  fence it out). ``PADDLE_TPU_NODE_DIE_WITH_RANK=<grank>`` anchors a
  whole-node death to worker progress instead of wall time: when that
  local worker dies by SIGKILL, the agent takes the rest of the node
  with it.

Markers on stdout (one per line, parsed by chaos tests and bench):
    AGENT <node_id> REGISTERED store=<host:port>
    ROUND <n> world=<w> node_rank=<r> ranks=<lo>-<hi>
    STANDBY <n>                    this round runs without us (we beat on)
    FENCED <n>                     stale workers killed before applying <n>
    NODE_DIE <wall_ts>             whole-node SIGKILL follows immediately
    STORE_FAILOVER <incarnation>   re-homed + re-registered
    QUARANTINED <n>                excluded for flakiness: agent exits
    NODE_DONE / NODE_FAILED <rcs> / NODE_PREEMPTED
    AGENT_EXIT <rc>
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

from .. import fault as _fault
from ..elastic import NodeRegistry
from ..tcp_store import FailoverStore, StoreCandidatesExhausted
from .main import _PKG_ROOT, _terminate_survivors

__all__ = ["NodeAgent", "main"]


def _parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch.node_agent",
        description="per-node supervisor for multi-host elastic jobs")
    p.add_argument("--node_id", required=True,
                   help="stable node identity inside the job")
    p.add_argument("--ordinal", type=int, default=0,
                   help="node ordinal for %%N fault filters (the agent "
                        "exports it as its own PADDLE_TPU_PROCESS_ID)")
    p.add_argument("--job_id", default="default")
    p.add_argument("--store", required=True,
                   help="registry candidates 'host:p1[,host:p2]' — the "
                        "second candidate is the warm standby")
    p.add_argument("--nproc_per_node", type=int, default=1)
    p.add_argument("--ttl", type=float, default=10.0,
                   help="heartbeat liveness window (seconds)")
    p.add_argument("--terminate_grace", type=float, default=10.0)
    p.add_argument("--log_dir", default="log")
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


class NodeAgent:
    def __init__(self, args):
        self.args = args
        self.node_id = args.node_id
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.procs = []          # [(Popen, log_path, grank)]
        self.round_no = 0        # last spec applied (0 = none yet)
        self.status = "idle"     # idle|running|done|failed|preempted|...
        self.rcs = []
        self.store = None
        self.registry = None
        self._spec = None

    # ------------------------------------------------------------ record
    def _record(self):
        with self._lock:
            return {
                "ord": self.args.ordinal,
                "host": socket.gethostname(),
                "pid": os.getpid(),
                "round": self.round_no,
                "status": self.status,
                "rcs": list(self.rcs),
                "store_inc": getattr(self.store, "incarnation", 0),
            }

    def _set_status(self, status, rcs=None):
        with self._lock:
            self.status = status
            if rcs is not None:
                self.rcs = list(rcs)
        try:
            self.registry.beat(self.node_id, self._record())
        except Exception:
            pass  # the heartbeat thread will carry it

    # --------------------------------------------------------- heartbeat
    def _beat_loop(self):
        from ..tcp_store import StoreFencedError
        while not self._stop.wait(self.args.ttl / 3.0):
            kind = _fault.maybe_inject("node_beat")
            if kind == "node_die":
                self._node_die()
            try:
                self.registry.beat(self.node_id, self._record())
            except StoreFencedError as e:
                # this agent kept writing to a deposed store lifetime
                # (asymmetric partition: everyone else failed over and
                # the fence swept back here). Agents are interchangeable
                # writers: re-home to the current lifetime, adopt its
                # epoch and re-register — only coordinators yield.
                print(f"[agent {self.node_id}] heartbeat fenced: {e}; "
                      "re-homing to the current store lifetime",
                      file=sys.stderr, flush=True)
                try:
                    self.registry.store.rehome(e)
                except Exception as e2:
                    print(f"[agent {self.node_id}] rehome failed: {e2}",
                          file=sys.stderr, flush=True)
            except Exception as e:
                print(f"[agent {self.node_id}] heartbeat failed: {e}",
                      file=sys.stderr, flush=True)

    def _node_die(self):
        """Sudden whole-node loss: no graceful anything — SIGKILL every
        local worker, then ourselves. The trailing wall stamp is the
        node-loss anchor bench --chaos measures detect-to-resume from."""
        print(f"NODE_DIE {time.time():.6f}", flush=True)
        sys.stdout.flush()
        for proc, _, _ in self.procs:
            if proc.poll() is None:
                try:
                    proc.kill()
                except OSError:
                    pass
        os.kill(os.getpid(), signal.SIGKILL)

    # ---------------------------------------------------------- failover
    def _on_failover(self, store, inc):
        """The registry master died and we re-homed to the standby: the
        standby is warm (running) but EMPTY, so re-register this node
        under the bumped store incarnation."""
        print(f"STORE_FAILOVER {inc}", flush=True)
        try:
            self.registry.register(self.node_id, self._record())
        except Exception as e:
            print(f"[agent {self.node_id}] re-register after failover "
                  f"failed: {e}", file=sys.stderr, flush=True)

    # ------------------------------------------------------------ workers
    def _worker_env(self, spec, local_rank):
        node_rank = spec["nodes"][self.node_id]
        world = spec["world"]
        grank = node_rank * spec["nproc"] + local_rank
        env = dict(os.environ)
        # membership is node-scoped here: workers must not self-register
        # into the worker-level (--np) registry even if its env leaked
        for k in ("PADDLE_TPU_ELASTIC_JOB_ID", "PADDLE_TPU_ELASTIC_STORE",
                  "PADDLE_TPU_ELASTIC_NP", "PADDLE_TPU_ELASTIC_TTL",
                  "PADDLE_TPU_ELASTIC_NAME"):
            env.pop(k, None)
        env.update({
            "PADDLE_TPU_NUM_PROCESSES": str(world),
            "PADDLE_TPU_PROCESS_ID": str(grank),
            "PADDLE_TPU_RESTART_NUM": str(spec["round"] - 1),
            "PADDLE_TRAINER_ID": str(grank),
            "PADDLE_TRAINERS_NUM": str(world),
            "PADDLE_TPU_WORKERLOG_DIR": os.path.abspath(self.args.log_dir),
            "PADDLE_TPU_NODE_ID": self.node_id,
            "PADDLE_TPU_NODE_RANK": str(node_rank),
            "PADDLE_TPU_NNODES": str(len(spec["nodes"])),
            "PADDLE_TPU_NODE_AGENT": "1",
            "PADDLE_TPU_STORE_INCARNATION": str(spec.get("store_inc", 0)),
        })
        if world > 1:
            env["PADDLE_TPU_COORDINATOR"] = spec["master"]
        else:
            env.pop("PADDLE_TPU_COORDINATOR", None)
        paths = env.get("PYTHONPATH", "").split(os.pathsep)
        if _PKG_ROOT not in paths:
            env["PYTHONPATH"] = os.pathsep.join(
                [_PKG_ROOT] + [p for p in paths if p])
        return env, grank

    def _spawn_round(self, spec):
        os.makedirs(self.args.log_dir, exist_ok=True)
        node_rank = spec["nodes"][self.node_id]
        restart = spec["round"] - 1
        procs = []
        for lr in range(spec["nproc"]):
            env, grank = self._worker_env(spec, lr)
            log_path = os.path.join(
                self.args.log_dir,
                f"workerlog.{grank}"
                + (f".restart{restart}" if restart else ""))
            log_f = open(log_path, "w")
            proc = subprocess.Popen(
                [sys.executable, self.args.training_script]
                + self.args.training_script_args,
                env=env, stdout=log_f, stderr=subprocess.STDOUT)
            log_f.close()
            procs.append((proc, log_path, grank))
        self.procs = procs
        lo = node_rank * spec["nproc"]
        print(f"ROUND {spec['round']} world={spec['world']} "
              f"node_rank={node_rank} ranks={lo}-{lo + spec['nproc'] - 1}",
              flush=True)

    def _teardown(self, reason=None):
        if not self.procs:
            return
        if reason:
            print(reason, flush=True)
        _terminate_survivors([(p, lp) for p, lp, _ in self.procs],
                             self.args.terminate_grace)
        self.procs = []

    def _apply_round(self, spec):
        if self.procs:
            # any workers still alive belong to a superseded round: fence
            # them before touching the new one
            self._teardown(f"FENCED {spec['round']}")
        self._spec = spec
        with self._lock:
            self.round_no = spec["round"]
            self.rcs = []
        if self.node_id in spec.get("quarantined", ()):
            print(f"QUARANTINED {spec['round']}", flush=True)
            self._set_status("quarantined")
            raise SystemExit(0)
        if self.node_id in spec["nodes"]:
            self._spawn_round(spec)
            self._set_status("running")
        else:
            print(f"STANDBY {spec['round']}", flush=True)
            self._set_status("standby")

    # ------------------------------------------------------- supervision
    def _poll_workers(self):
        if not self.procs or self.status != "running":
            return
        procs = self.procs
        rcs = [p.poll() for p, _, _ in procs]
        die_rank = os.environ.get("PADDLE_TPU_NODE_DIE_WITH_RANK")
        if die_rank:
            for (p, _, grank), rc in zip(procs, rcs):
                if str(grank) == die_rank and rc == -signal.SIGKILL:
                    # chaos anchor: that worker's SIGKILL stands for the
                    # whole host going away
                    self._node_die()
        first_bad = next((rc for rc in rcs
                          if rc is not None and rc != 0), None)
        if first_bad is not None and any(rc is None for rc in rcs):
            self._teardown(
                f"[agent {self.node_id}] worker failed "
                f"({_fault.describe_exit(first_bad)}); terminating local "
                "survivors")
            rcs = [p.poll() for p, _, _ in procs]  # all reaped now
        if any(rc is None for rc in rcs):
            return
        self.procs = []
        if all(rc == 0 for rc in rcs):
            print("NODE_DONE", flush=True)
            self._set_status("done", rcs)
        elif all(rc in (0, _fault.EXIT_PREEMPT) for rc in rcs):
            print("NODE_PREEMPTED", flush=True)
            self._set_status("preempted", rcs)
        else:
            print(f"NODE_FAILED {rcs}", flush=True)
            self._set_status("failed", rcs)

    # --------------------------------------------------------------- run
    def run(self) -> int:
        # node-scoped faults filter by node ordinal: export it as OUR
        # process id (workers get their own global rank on top)
        os.environ["PADDLE_TPU_PROCESS_ID"] = str(self.args.ordinal)
        self.store = FailoverStore(self.args.store,
                                   on_failover=self._on_failover)
        self.registry = NodeRegistry(self.store, self.args.job_id,
                                     ttl=self.args.ttl)
        self.registry.register(self.node_id, self._record())
        host, port = self.store.active_endpoint
        print(f"AGENT {self.node_id} REGISTERED store={host}:{port}",
              flush=True)
        beat = threading.Thread(target=self._beat_loop, daemon=True,
                                name="node-agent-beat")
        beat.start()
        # orphan fencing: a registry whose EVERY candidate stays
        # unreachable past this long means the control plane is GONE
        # (the coordinator died with no standby, or this node is
        # partitioned) — running stale workers forever would be the
        # split-brain zombie the round fencing exists to prevent, so the
        # node fences itself. Only StoreCandidatesExhausted arms the
        # clock: a clean failover re-homes INSIDE
        # poll() and returns normally, and transient wobble (one slow op
        # mid-failover) must never count toward fencing a healthy node —
        # with a live standby the orphan window is the shadow
        # coordinator's takeover budget, not a cluster-wide suicide pact.
        env_orphan = os.environ.get("PADDLE_TPU_AGENT_ORPHAN_S")
        orphan_s = float(env_orphan) if env_orphan \
            else max(60.0, 6 * self.args.ttl)
        exhausted_since = None
        failing_since = None  # ANY-failure fallback clock (3x window)
        try:
            while True:
                try:
                    complete, cur = self.registry.poll()
                    if complete:
                        self._teardown(
                            f"[agent {self.node_id}] job complete")
                        self._set_status("exited")
                        return 0
                    if cur > self.round_no:
                        spec = self.registry.round(cur)
                        if spec is not None:
                            self._apply_round(spec)
                    exhausted_since = failing_since = None
                except SystemExit:
                    raise
                except StoreCandidatesExhausted as e:
                    print(f"[agent {self.node_id}] registry poll failed: "
                          f"{e} (all candidates exhausted)",
                          file=sys.stderr, flush=True)
                    now = time.monotonic()
                    exhausted_since = exhausted_since or now
                    failing_since = failing_since or now
                    if now - exhausted_since > orphan_s:
                        self._teardown(
                            f"[agent {self.node_id}] registry unreachable "
                            f"for {orphan_s:.0f}s: control plane presumed "
                            "gone; fencing this node")
                        print("AGENT_ORPHANED", flush=True)
                        return 3
                except Exception as e:
                    # registry wobble (mid-failover, a re-homed standby
                    # warming up): keep supervising without arming the
                    # FAST orphan clock — the FailoverStore recovers or
                    # escalates to StoreCandidatesExhausted above. The
                    # 3x fallback clock still runs: a wedged store that
                    # accepts connects but fails every op forever must
                    # not keep stale workers alive indefinitely.
                    print(f"[agent {self.node_id}] registry poll failed: "
                          f"{e}", file=sys.stderr, flush=True)
                    failing_since = failing_since or time.monotonic()
                    if time.monotonic() - failing_since > 3 * orphan_s:
                        self._teardown(
                            f"[agent {self.node_id}] registry unhealthy "
                            f"(every poll failing) for {3 * orphan_s:.0f}"
                            "s: control plane presumed wedged; fencing "
                            "this node")
                        print("AGENT_ORPHANED", flush=True)
                        return 3
                self._poll_workers()
                time.sleep(0.2)
        finally:
            self._stop.set()


def main(argv=None):
    agent = NodeAgent(_parse_args(argv))
    try:
        rc = agent.run()
    except SystemExit as e:
        rc = int(e.code or 0)
    except KeyboardInterrupt:
        rc = 130
    agent._teardown(f"[agent {agent.node_id}] shutting down")
    print(f"AGENT_EXIT {rc}", flush=True)
    sys.exit(rc)


if __name__ == "__main__":
    main()
