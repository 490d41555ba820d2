"""The launcher, the port's copy of ``paddle_tpu/distributed/launch/
main.py`` (reference: launch/main.py + controllers/collective.py).

``python -m paddle_tpu_torch.distributed.launch --nproc_per_node N
[--max_restarts R] [--log_dir D] script.py args...`` starts N worker
processes of one host, each with the JAX launcher's environment
(``PADDLE_TPU_PROCESS_ID``, ``PADDLE_TPU_NUM_PROCESSES``,
``PADDLE_TPU_RESTART_NUM``, ``PADDLE_TRAINER_ID`` /
``PADDLE_TRAINERS_NUM``, ``PADDLE_TPU_COORDINATOR`` — the rendezvous
address of ``init_parallel_env``'s gloo process group — and
``PADDLE_TPU_WORKERLOG_DIR``, and the import path of the checkout that
holds ``paddle_tpu_torch``), its log in
``<log_dir>/workerlog.<rank>[.restart<n>]``. ``--np MIN:MAX`` makes
the job elastic over worker processes, ``--nnodes MIN:MAX`` over whole
nodes, each run by a :mod:`.node_agent`.

Fault-tolerance contract (distributed/fault.py):

- Workers are POLLED concurrently; on the first nonzero exit the
  survivors are terminated (SIGTERM, then SIGKILL after a grace period)
  before restarting — a dead peer must not leave the rest blocked
  forever inside a collective.
- Exit code ``EXIT_PREEMPT`` (75) marks a graceful-preemption save: the
  job is relaunched WITHOUT consuming ``--max_restarts`` (bounded only
  by ``--max_preempt_restarts`` as a runaway guard).
- With ``--max_restarts > 0`` the per-step watchdog is armed by default
  (``PADDLE_TPU_WATCHDOG_TIMEOUT`` forwarded to workers, override or
  set 0 to disable): a hung collective converts into an escalated abort
  (flight-recorder dump + blame, exit 19; native exit-17 backstop) and
  thus a restart instead of a stuck job. Worker exit codes are mapped to
  causes via ``fault.describe_exit``; after any failure the launcher
  prints a per-rank flight-recorder post-mortem when dumps exist in
  ``--log_dir`` (workers learn it via ``PADDLE_TPU_WORKERLOG_DIR``).
- When ``PADDLE_TPU_FAULTS`` is set, a fault ledger file under
  ``--log_dir`` is exported so deterministic injections fire once per
  job, not once per incarnation.

Elastic rendezvous (``--np min:max``, reference fleet/elastic/manager.py):
the launcher owns an ``ElasticManager`` registry (TCPStore) that every
worker registers + heartbeats into via ``init_parallel_env``. A worker
death that leaves the live world inside ``[min_np, max_np]`` is a *scale
event*, not a fatal exit: survivors are torn down and the job relaunches
with the smaller world size (``PADDLE_TRAINERS_NUM`` / ranks re-rendered);
a node joining the registry mid-run or during the below-``min_np`` HOLD
window widens the world back up (bounded by ``max_np``). State recovery
across scale events is the checkpoint lineage's job (resumable trainers
reload the newest verified snapshot).

Multi-host elastic (``--nnodes MIN:MAX``): the unit of membership becomes
a whole NODE. This launcher turns into the *coordinator*: it serves the
rendezvous registry (primary + optional warm-standby TCPStore — a second
comma-separated ``--master`` candidate), waits for per-node agents
(``launch/node_agent.py``; spawned locally for the single-machine pod
simulation, one per host in a real pod) to register, and publishes round
specs the agents apply. Node loss inside [MIN, MAX] nodes re-renders the
world across the SURVIVING agents and relaunches at the smaller scale;
joins/standbys backfill exactly like the single-host path; repeated
failures of the same node inside ``--quarantine_window`` move it to a
quarantine list (capacity degrades, the job never livelocks in relaunch
cycles); death of the primary registry master re-homes every client onto
the standby under a bumped store incarnation.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

from .. import keyspace
from ..fault import (EXIT_DEPOSED, EXIT_INTEGRITY, EXIT_PREEMPT,
                     EXIT_USAGE, describe_exit)
from ..topology import FailureDomainMap

__all__ = ["launch", "main", "CoordinatorDeposedError"]


class CoordinatorDeposedError(RuntimeError):
    """This coordinator's lease term was superseded: a shadow adopted the
    round while we were partitioned/presumed dead. The only safe move is
    to yield (exit ``EXIT_DEPOSED``) — two coordinators publishing rounds
    would split-brain the agents."""

# the checkout that holds the paddle_tpu_torch package: workers must be
# able to import it whatever their script's directory
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def _parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="launch a multi-host paddle_tpu_torch training job")
    p.add_argument("--nnodes", default="1",
                   help="number of hosts: 'N' (fixed, this process "
                        "launches one host's workers) or 'MIN:MAX' "
                        "(node-level elastic: this process becomes the "
                        "coordinator of per-node agents)")
    p.add_argument("--node_rank", type=int,
                   default=int(os.environ.get("PADDLE_TPU_NODE_RANK", 0)),
                   help="rank of this host")
    p.add_argument("--master", default=os.environ.get(
        "PADDLE_TPU_COORDINATOR", "127.0.0.1:8476"),
        help="coordinator address host:port (rank-0 host); a second "
             "comma-separated candidate becomes the warm-standby "
             "rendezvous registry for --nnodes MIN:MAX jobs")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="processes per host (one per card)")
    p.add_argument("--np", default=None, dest="np_spec", metavar="MIN:MAX",
                   help="elastic world-size range 'N' or 'min:max': worker "
                        "loss inside the range relaunches at the smaller "
                        "world instead of failing; joins widen it back up")
    p.add_argument("--job_id", default=os.environ.get(
        "PADDLE_TPU_JOB_ID", "default"),
        help="elastic job id (registry namespace)")
    p.add_argument("--elastic_port", type=int, default=0,
                   help="TCPStore port of the elastic registry "
                        "(default: master port + 1)")
    p.add_argument("--elastic_ttl", type=float, default=10.0,
                   help="heartbeat liveness window (seconds)")
    p.add_argument("--elastic_timeout", type=float, default=120.0,
                   help="HOLD: how long to wait for node joins when the "
                        "live world fell below min_np")
    p.add_argument("--max_elastic_events", type=int, default=16,
                   help="runaway guard for scale-event relaunches (scale "
                        "events do not consume --max_restarts)")
    p.add_argument("--coordinator_role", default="auto",
                   choices=("auto", "primary", "shadow"),
                   help="control-plane role for --nnodes MIN:MAX with a "
                        "standby --master candidate: 'auto' (default) "
                        "serves every locally bindable registry candidate "
                        "(single-machine pod simulation); 'primary' "
                        "serves only the first candidate and holds the "
                        "coordinator lease; 'shadow' (run on the standby "
                        "host) serves the standby candidate(s), tails "
                        "the primary's replication log, and adopts the "
                        "published round when the primary's lease "
                        "expires — takeover without re-rendezvous")
    p.add_argument("--local_agents", type=int, default=-1,
                   help="node agents this coordinator spawns locally for "
                        "--nnodes MIN:MAX (default: MAX — the single-"
                        "machine pod simulation; real pods run one "
                        "launch.node_agent per host and pass 0)")
    p.add_argument("--quarantine_window", type=float, default=300.0,
                   help="sliding window (seconds) for flaky-node "
                        "quarantine")
    p.add_argument("--quarantine_threshold", type=int, default=2,
                   help="blamed failures of one node inside the window "
                        "that quarantine it")
    p.add_argument("--log_dir", default="log", help="per-rank log directory")
    p.add_argument("--max_restarts", type=int, default=0,
                   help="relaunch failed workers up to N times (elastic)")
    p.add_argument("--max_preempt_restarts", type=int, default=16,
                   help="runaway guard for preemption resumes (exit code "
                        f"{EXIT_PREEMPT} does not consume --max_restarts)")
    p.add_argument("--watchdog_timeout", type=float, default=300.0,
                   help="default PADDLE_TPU_WATCHDOG_TIMEOUT armed when "
                        "--max_restarts > 0 (0 disables)")
    p.add_argument("--terminate_grace", type=float, default=10.0,
                   help="seconds between SIGTERM and SIGKILL when tearing "
                        "down survivors of a failed peer")
    p.add_argument("training_script", help="script to run")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _spawn(args, local_rank, restart_count, extra_env=None, world_np=None):
    """Spawn one worker. ``world_np`` overrides the world size (elastic
    relaunch at a new scale re-renders PADDLE_TRAINERS_NUM + ranks)."""
    if world_np is not None:
        global_rank, world = local_rank, world_np
    else:
        global_rank = args.node_rank * args.nproc_per_node + local_rank
        world = args.nnodes * args.nproc_per_node
    env = dict(os.environ)
    env.update(extra_env or {})
    env.update({
        "PADDLE_TPU_COORDINATOR": args.master if world > 1 else "",
        "PADDLE_TPU_NUM_PROCESSES": str(world),
        "PADDLE_TPU_PROCESS_ID": str(global_rank),
        "PADDLE_TPU_RESTART_NUM": str(restart_count),
        # reference-compatible names (fleet env bootstrap)
        "PADDLE_TRAINER_ID": str(global_rank),
        "PADDLE_TRAINERS_NUM": str(world),
        # flight-recorder dumps + watchdog post-mortems land here
        "PADDLE_TPU_WORKERLOG_DIR": os.path.abspath(args.log_dir),
    })
    if not env["PADDLE_TPU_COORDINATOR"]:
        env.pop("PADDLE_TPU_COORDINATOR")
    paths = env.get("PYTHONPATH", "").split(os.pathsep)
    if _PKG_ROOT not in paths:
        env["PYTHONPATH"] = os.pathsep.join([_PKG_ROOT] + [p for p in paths
                                                           if p])
    os.makedirs(args.log_dir, exist_ok=True)
    log_path = os.path.join(args.log_dir,
                            f"workerlog.{global_rank}"
                            + (f".restart{restart_count}" if restart_count
                               else ""))
    log_f = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, args.training_script] + args.training_script_args,
        env=env, stdout=log_f, stderr=subprocess.STDOUT)
    log_f.close()  # the child holds its own fd copy
    return proc, log_path


def _clear_dumps(log_dir):
    """Drop flight-recorder dumps AND metrics snapshots left by a previous
    spawn round (or a previous job sharing this log dir): each round's
    post-mortem/run-report must describe THAT round, not blame a
    restart's crash on the stale artifacts of an earlier incarnation."""
    import glob
    for pat in ("flight_recorder.*.json", "metrics.*.jsonl",
                "trace.*.json"):
        for p in glob.glob(os.path.join(log_dir, pat)):
            try:
                os.unlink(p)
            except OSError:
                pass


def _run_report(log_dir):
    """Aggregate the per-rank telemetry JSONL (PADDLE_TPU_METRICS=1
    workers) into the one-screen cross-rank run report — slowest rank,
    p50/p99 collective latency, MFU. Printed at round end and from the
    failure post-mortem path; silent when no worker wrote metrics."""
    try:
        from ...observability import report as _report
        text = _report.format_run_report(
            _report.build_run_report(_report.read_rank_snapshots(log_dir)))
    except Exception:
        return
    if text:
        print(text, file=sys.stderr, flush=True)


def _post_mortem(log_dir):
    """One-screen flight-recorder post-mortem after a worker failure:
    collect the per-rank dumps the workers wrote into ``log_dir`` and
    print the blame summary ("rank 2 stalled before all_reduce seq=417").
    Silent when no worker dumped."""
    try:
        from ..flight_recorder import collect_dumps, format_post_mortem
        text = format_post_mortem(collect_dumps(log_dir))
    except Exception:
        text = None
    if text:
        print(text, file=sys.stderr, flush=True)
    # the failure post-mortem doubles as a performance post-mortem: the
    # last metrics snapshots often name the straggler before the hang
    _run_report(log_dir)


def _terminate_survivors(procs, grace):
    """SIGTERM every live worker (graceful-save window), escalate to
    SIGKILL after ``grace`` seconds."""
    for proc, _ in procs:
        if proc.poll() is None:
            try:
                proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
    deadline = time.time() + grace
    for proc, _ in procs:
        while proc.poll() is None:
            if time.time() >= deadline:
                try:
                    proc.kill()
                except OSError:
                    pass
                proc.wait()
                break
            time.sleep(0.1)


def _wait_any_failure(procs, poll_interval=0.2, on_poll=None,
                      settle=0.0):
    """Poll ALL workers concurrently; return (rcs, first_bad, event) where
    first_bad is (rc, log_path) of the earliest observed failure (None if
    every worker exited 0) and event is the first TRUTHY value returned
    by ``on_poll()`` (elastic join watcher; an empty join list is not an
    event) — a pending event aborts the wait with workers still running.
    The old sequential ``proc.wait()``
    loop blocked on worker 0 while a crashed peer left the survivors hung
    in collectives forever. ``settle`` keeps polling that many seconds
    after the first failure so simultaneous deaths (a whole host lost)
    are counted as ONE scale event, not several."""
    rcs = [None] * len(procs)
    first_bad = None
    bad_since = None
    while any(rc is None for rc in rcs):
        for i, (proc, log_path) in enumerate(procs):
            if rcs[i] is None:
                rc = proc.poll()
                if rc is not None:
                    rcs[i] = rc
                    if rc != 0 and first_bad is None:
                        first_bad = (rc, log_path)
        if first_bad is not None and any(rc is None for rc in rcs):
            bad_since = bad_since or time.time()
            if time.time() - bad_since >= settle:
                return rcs, first_bad, None
        elif first_bad is None and on_poll is not None:
            # a failure observed in this same sweep wins over a join: the
            # scale-down branch re-polls joins itself, so the joiner is
            # counted as backfill there instead of masking the loss
            event = on_poll()
            if event:
                return rcs, first_bad, event
        if any(rc is None for rc in rcs):
            time.sleep(poll_interval)
    return rcs, first_bad, None


class _ElasticState:
    """Launcher-side handle on the rendezvous registry: owns the master
    TCPStore, assigns per-round worker names, and watches the join-seq for
    outsiders (scale-out)."""

    def __init__(self, args):
        from ..elastic import ElasticManager
        self.min_np, self.max_np = ElasticManager._parse_np(args.np_spec)
        host, _, mport = args.master.partition(":")
        self.host = host or "127.0.0.1"
        self.port = args.elastic_port or int(mport or 8476) + 1
        self.manager = ElasticManager(
            args.job_id, args.np_spec, host=self.host, port=self.port,
            is_master=True, ttl=args.elastic_ttl)
        self.assigned = set()   # every name this launcher ever handed out
        self.standby = []       # joiners seen while already at max_np
        self.events = 0

    def worker_env(self, args):
        return {
            "PADDLE_TPU_ELASTIC_JOB_ID": args.job_id,
            "PADDLE_TPU_ELASTIC_STORE": f"{self.host}:{self.port}",
            "PADDLE_TPU_ELASTIC_NP": str(args.np_spec),
            "PADDLE_TPU_ELASTIC_TTL": str(args.elastic_ttl),
        }

    def round_names(self, spawn_round, cur_np):
        names = [f"r{spawn_round}-w{r}" for r in range(cur_np)]
        self.assigned.update(names)
        self.manager.announce(names)
        return names

    def joins(self):
        """Names registered into the job that this launcher never spawned
        (an operator adding capacity) — ignore errors, joins are advisory."""
        try:
            return self.manager.new_joins(self.assigned)
        except Exception:
            return []

    def absorb(self, names):
        """Mark joiners as processed so one join is one scale event, not a
        scale event per poll."""
        self.assigned.update(names)

    def hold_for_joins(self, need, deadline_s, interval=0.5):
        """Below min_np: HOLD, waiting for at least ``need`` joiners with
        live heartbeats (they keep beating while they wait)."""
        deadline = time.time() + deadline_s
        while time.time() < deadline:
            fresh = self.joins()
            if len(fresh) >= need:
                return fresh
            time.sleep(interval)
        return self.joins()


class _NodeCoordinator:
    """Rank-0-side control plane of a ``--nnodes MIN:MAX`` job: serves
    the rendezvous registry (primary + warm standby), rendezvouses node
    agents, publishes round specs, and turns node loss / join / flaky
    repetition into scale / backfill / quarantine decisions. A whole node
    is the unit of membership; worker-level supervision lives in the
    agents."""

    def __init__(self, args, extra_env, min_nodes, max_nodes):
        from ..elastic import (NodeRegistry, QuarantineList,
                               render_node_round)
        from ..tcp_store import FailoverStore, LogShipper, TCPStore
        self.args = args
        self.extra_env = dict(extra_env)
        self.min_nodes, self.max_nodes = min_nodes, max_nodes
        self.role = getattr(args, "coordinator_role", "auto")
        self._render = render_node_round
        cands = [c.strip() for c in args.master.split(",") if c.strip()]
        self.master = cands[0]
        host0, _, p0 = self.master.partition(":")
        eps = [(host0 or "127.0.0.1",
                args.elastic_port or int(p0 or 8476) + 1)]
        for cand in cands[1:]:
            h, _, p = cand.partition(":")
            # a portless standby candidate inherits the primary's port
            # (it lives on a different host) instead of dying on int('')
            eps.append((h or "127.0.0.1", int(p or p0 or 8476) + 1))
        self.eps = eps
        # which candidates this process serves: 'auto' = every locally
        # bindable one (single-machine pod simulation; in a real pod the
        # other host's bind simply fails), 'primary' = only the first
        # (a shadow on the standby host serves the rest), 'shadow' =
        # everything BUT the first
        if self.role == "primary":
            mine = {0}
        elif self.role == "shadow":
            mine = set(range(1, len(eps)))
        else:
            mine = set(range(len(eps)))
        self.servers = []
        for i, (host, port) in enumerate(eps):
            if i not in mine:
                self.servers.append(None)
                continue
            try:
                self.servers.append(TCPStore(host, port, is_master=True))
            except Exception as e:
                self.servers.append(None)
                print(f"[elastic] registry candidate {host}:{port} served "
                      f"elsewhere ({e})", file=sys.stderr, flush=True)
        self.current_spec = None
        self._failover_at = None
        self.store = FailoverStore(eps, on_failover=self._on_failover)
        # the coordinator's authority is the lease TERM, not the store
        # epoch: a shadow that deposed a slow-but-alive primary sits on
        # its own standby when the agents re-home onto it and bump the
        # fence epoch — without this resolver it would fence ITSELF out
        # of the lifetime it just adopted (and the job would lose both
        # coordinators). The resolver re-reads the term per event, so a
        # genuinely deposed coordinator still raises.
        self.store._fence_resolver = self._still_holds_term
        self.registry = NodeRegistry(self.store, args.job_id,
                                     ttl=args.elastic_ttl)
        self.quarantine = QuarantineList(args.quarantine_window,
                                         args.quarantine_threshold)
        self.known = []       # every node id ever seen, join order
        self.events = 0
        self.preempt_restarts = 0
        self.agent_procs = []
        self.settle = args.elastic_ttl + 1.0
        self._loss_logged = set()
        # control-plane replication: whoever serves a STANDBY
        # candidate ships the primary's op log onto it, so a promoted
        # standby already holds round history/membership/join-seq
        self._shippers = []
        if len(eps) > 1:
            primary_ep = f"{eps[0][0]}:{eps[0][1]}"
            standbys = list(range(1, len(eps)))
            for i in standbys:
                if self.servers[i] is None:
                    continue
                sh = LogShipper(primary_ep,
                                f"{eps[i][0]}:{eps[i][1]}",
                                standby_index=i, peer_indices=standbys)
                sh.start()
                self._shippers.append(sh)
        # coordinator lease: only meaningful when a standby exists (a
        # shadow watches it); single-candidate jobs skip every lease op
        # so the legacy hot path is untouched
        self._lease_on = len(eps) > 1
        self._term = 0
        self._lease_next = 0.0
        self._adopted = False
        self._deposed = False
        self._coord_prefix = keyspace.elastic_coord(args.job_id)

    # ------------------------------------------------------------ setup
    def _spawn_local_agents(self, count):
        os.makedirs(self.args.log_dir, exist_ok=True)
        store_arg = ",".join(f"{h}:{p}" for h, p in self.eps)
        for i in range(count):
            node_id = f"node{i}"
            env = dict(os.environ)
            env.update(self.extra_env)
            paths = env.get("PYTHONPATH", "").split(os.pathsep)
            if _PKG_ROOT not in paths:
                env["PYTHONPATH"] = os.pathsep.join(
                    [_PKG_ROOT] + [p for p in paths if p])
            log_f = open(os.path.join(self.args.log_dir,
                                      f"agentlog.{node_id}"), "w")
            proc = subprocess.Popen(
                [sys.executable, "-m",
                 "paddle_tpu_torch.distributed.launch.node_agent",
                 "--node_id", node_id, "--ordinal", str(i),
                 "--job_id", self.args.job_id,
                 "--store", store_arg,
                 "--nproc_per_node", str(self.args.nproc_per_node),
                 "--ttl", str(self.args.elastic_ttl),
                 "--terminate_grace", str(self.args.terminate_grace),
                 "--log_dir", self.args.log_dir,
                 self.args.training_script]
                + self.args.training_script_args,
                env=env, stdout=log_f, stderr=subprocess.STDOUT)
            log_f.close()
            self.agent_procs.append(proc)

    def _on_failover(self, store, inc):
        """Our own client re-homed to the standby. With log-shipped
        replication the promoted standby usually already holds the
        current round (the shipper tailed it over) — the republish below
        is then skipped and this callback is a pure gap-filler for the
        un-acked WAL tail; only an un-replicated (or badly lagged)
        standby gets the full same-round reinstall. Either way the round
        NUMBER never changes, so agents keep their workers running."""
        self._failover_at = time.monotonic()
        print(f"[elastic] registry master lost: failed over to standby "
              f"(store incarnation {inc})", file=sys.stderr, flush=True)
        if self.current_spec is None:
            return
        no = int(self.current_spec["round"])
        try:
            there = self.registry.round(no, probe=True)
            if there is not None and int(there.get("round", -1)) == no:
                print(f"[elastic] round {no} preserved by replication "
                      "(no republish needed; gap-filling the un-acked "
                      "tail only)", file=sys.stderr, flush=True)
                return
        except Exception:
            pass
        try:
            self.registry.republish_round(self.current_spec)
        except Exception as e:
            print(f"[elastic] round republish failed: {e}",
                  file=sys.stderr, flush=True)

    # ----------------------------------------------------- lease + state
    def _coord_key(self, leaf):
        return f"{self._coord_prefix}/{leaf}"

    def _still_holds_term(self):
        """Fence resolver for the coordinator's store client: True when
        this coordinator's lease term is still the current one (so a
        store-epoch move under it — the agents re-homing onto the store
        it adopted — must be adopted, not treated as deposition)."""
        if not self._lease_on or self._term <= 0:
            return False
        try:
            return int(self.store.add(self._coord_key("term"), 0)) \
                == self._term
        except Exception:
            return False

    def _acquire_lease(self):
        """Take the next coordinator term and publish the first lease.
        The term counter is the fence: a shadow adopting the round bumps
        it, and every later renewal by the deposed holder is rejected."""
        if not self._lease_on:
            return
        self._term = int(self.store.add(self._coord_key("term"), 1))
        self._publish_lease()

    def _publish_lease(self):
        # cadence (ttl/3) is owned by _coord_beat's own throttle; every
        # direct caller wants the publish NOW
        if not self._lease_on:
            return
        self._lease_next = time.monotonic() + self.args.elastic_ttl / 3.0
        cur = int(self.store.add(self._coord_key("term"), 0))
        if cur != self._term:
            from ..flight_recorder import note_fenced
            note_fenced("coord_fenced", self._term, cur)
            raise CoordinatorDeposedError(
                f"coordinator lease term moved {self._term} -> {cur}: a "
                "shadow adopted the round while this coordinator was "
                "presumed dead")
        self.store.set(self._coord_key("lease"), json.dumps({
            "term": self._term, "ts": time.time(), "pid": os.getpid(),
            "role": self.role}).encode())

    def _coord_beat(self):
        """One control-plane heartbeat, throttled to the lease cadence
        (ttl/3): the ``coord_beat`` chaos site (``coordinator_die`` =
        sudden SIGKILL of this process, taking its in-process primary
        registry server with it — trigger N is the Nth lease beat, so
        chaos timing is deterministic in beats, not loop iterations)
        plus the lease renewal with its deposed-term fence."""
        if not self._lease_on or time.monotonic() < self._lease_next:
            return
        from .. import fault as _fault
        if _fault.maybe_inject("coord_beat") == "coordinator_die":
            print(f"COORDINATOR_DIE {time.time():.6f}", flush=True)
            print("[elastic] injected coordinator_die: SIGKILL self (the "
                  "in-process primary registry server dies with it)",
                  file=sys.stderr, flush=True)
            sys.stdout.flush()
            sys.stderr.flush()
            os.kill(os.getpid(), signal.SIGKILL)
        self._publish_lease()

    def _sweep_term(self):
        """Best-effort STONITH for the coordinator lease: push the
        adopted term onto every candidate DIRECTLY, not just the one our
        own client happens to be homed on. The takeover's term bump
        lands on the shadow's active store; a deposed-but-alive primary
        reads the term from ITS active store at every lease renewal —
        without the sweep, a takeover triggered by replication lag or a
        slow primary (rather than primary death) would leave the healthy
        primary supervising a second world. With it, the primary sees
        the moved term at its next beat and yields (exit 76). Still
        best-effort by design: a candidate on the far side of a true
        network partition stays unswept until the partition heals —
        closing THAT window needs quorum writes, which this control
        plane deliberately trades for a 2-candidate footprint (the
        agents' store fence still rejects the deposed lifetime's writes
        on re-home)."""
        from ..tcp_store import sweep_counter
        sweep_counter(self.eps, self._coord_key("term"), self._term,
                      name="coord-term-sweep")

    def _publish_coord_state(self):
        """Checkpoint the round state into the replicated store so a
        shadow can adopt it: the spec, the join-order roster, the
        quarantine ledger and the event budgets."""
        if not self._lease_on or self.current_spec is None:
            return
        state = {"spec": self.current_spec, "known": list(self.known),
                 "quarantine": self.quarantine.to_dict(),
                 "events": self.events,
                 "preempt_restarts": self.preempt_restarts,
                 "term": self._term, "ts": time.time()}
        from ..tcp_store import StoreFencedError
        try:
            self.store.set(self._coord_key("state"),
                           json.dumps(state).encode())
        except StoreFencedError:
            raise
        except Exception as e:
            print(f"[elastic] coordinator state checkpoint failed: {e}",
                  file=sys.stderr, flush=True)

    def _inject_store_die(self):
        from .. import fault as _fault
        if _fault.maybe_inject("elastic_store") == "store_die":
            print("[elastic] injected store_die: stopping the PRIMARY "
                  "registry server (master-node death)", file=sys.stderr,
                  flush=True)
            if self.servers and self.servers[0] is not None:
                self.servers[0].stop_server()

    # ------------------------------------------------------- membership
    def _scan_joins(self):
        """New node ids from the join log, quarantined ones filtered."""
        try:
            joined = self.registry.joined()
        except Exception:
            return []
        fresh = [n for n in joined if n not in self.known]
        self.known.extend(fresh)
        return [n for n in fresh if not self.quarantine.is_quarantined(n)]

    def _live_capacity(self):
        """Live, non-quarantined nodes in join order (standbys included:
        a join held at max_nodes backfills a later loss)."""
        try:
            live = self.registry.live(self.known)
        except Exception:
            return []
        return [n for n in self.known
                if n in live and not self.quarantine.is_quarantined(n)]

    def _rendezvous(self):
        """Wait for agents: full width returns immediately; a partial
        quorum >= MIN must hold stable for one ttl first, so stragglers
        of a simultaneous start make round 1 instead of triggering an
        immediate scale-out."""
        deadline = time.time() + self.args.elastic_timeout
        stable_since, last_n = time.time(), -1
        while time.time() < deadline:
            self._coord_beat()
            self._scan_joins()
            cap = self._live_capacity()
            if len(cap) >= self.max_nodes:
                return cap[:self.max_nodes]
            if len(cap) != last_n:
                last_n, stable_since = len(cap), time.time()
            if len(cap) >= self.min_nodes \
                    and time.time() - stable_since >= self.args.elastic_ttl:
                return cap
            time.sleep(0.25)
        return None

    # ------------------------------------------------------ round watch
    def _statuses(self, spec):
        """node -> status for the CURRENT round: an agent's reported
        status counts only once it applied this round; liveness always
        counts. 'missing' records right after a store failover are given
        a re-registration grace before they read as lost."""
        now = time.time()
        # post-failover grace: every agent is mid-re-home (a few seconds
        # of blocked heartbeats + an empty standby), so missing or stale
        # records must not read as node loss yet
        grace = (self._failover_at is not None
                 and time.monotonic() - self._failover_at
                 <= 2 * self.args.elastic_ttl)
        out = {}
        for nid in spec["nodes"]:
            rec = self.registry.record(nid)
            if rec is None:
                out[nid] = "pending" if grace else "lost"
            elif now - float(rec.get("ts", 0)) > self.args.elastic_ttl:
                out[nid] = "pending" if grace else "lost"
            elif int(rec.get("round", 0)) != spec["round"]:
                out[nid] = "pending"
            else:
                out[nid] = rec.get("status", "pending")
        return out, now

    def _blamed(self, spec, statuses):
        """Nodes causally at fault: lost hosts, and nodes whose agents
        reported a real worker failure EXIT (collateral signal deaths —
        survivors shot by a broken collective — shed no blame)."""
        blamed = []
        for nid, st in statuses.items():
            if st == "lost":
                blamed.append(nid)
            elif st == "failed":
                rec = self.registry.record(nid) or {}
                rcs = rec.get("rcs") or []
                if any(isinstance(rc, int) and rc > 0
                       and rc != EXIT_PREEMPT for rc in rcs):
                    blamed.append(nid)
        return blamed

    def _watch_round(self, spec):
        """Block until this round resolves. Returns (outcome, detail):
        'done' | 'preempt' | 'scale_out' (detail: joiners) |
        'failure' (detail: {statuses, blamed, rc})."""
        first_bad = None
        while True:
            self._inject_store_die()
            self._coord_beat()
            try:
                statuses, now = self._statuses(spec)
            except Exception as e:
                print(f"[elastic] registry read failed: {e}",
                      file=sys.stderr, flush=True)
                time.sleep(0.5)
                continue
            bad = {n: s for n, s in statuses.items()
                   if s in ("lost", "failed")}
            for nid, st in bad.items():
                if st == "lost" and nid not in self._loss_logged:
                    self._loss_logged.add(nid)
                    print(f"[elastic] node loss detected node={nid} "
                          f"wall={time.time():.6f} "
                          f"({self._domains.describe(nid)})",
                          file=sys.stderr, flush=True)
            if bad:
                first_bad = first_bad or time.monotonic()
                if time.monotonic() - first_bad >= self.settle:
                    statuses, _ = self._statuses(spec)  # final word
                    rcs = [rc for nid in spec["nodes"]
                           for rc in ((self.registry.record(nid) or {})
                                      .get("rcs") or [])
                           if isinstance(rc, int) and rc > 0]
                    return "failure", {
                        "statuses": statuses,
                        "blamed": self._blamed(spec, statuses),
                        "rc": rcs[0] if rcs else 1,
                    }
                time.sleep(0.25)
                continue
            first_bad = None  # a cleared blip must not shorten the next
            joiners = self._scan_joins()  # event's settle window
            if joiners:
                if len(spec["nodes"]) < self.max_nodes:
                    return "scale_out", joiners
                print(f"[elastic] join {joiners} held as standby: "
                      f"already at max_nnodes={self.max_nodes}",
                      file=sys.stderr, flush=True)
            vals = set(statuses.values())
            if vals == {"done"}:
                return "done", None
            if vals <= {"done", "preempted"} and "preempted" in vals:
                return "preempt", None
            time.sleep(0.25)

    # -------------------------------------------------------------- run
    def run(self):
        from ..tcp_store import StoreFencedError
        try:
            if self.role == "shadow":
                return self._run_shadow()
            return self._run()
        except (CoordinatorDeposedError, StoreFencedError) as e:
            self._deposed = True
            print(f"[elastic] deposed: {e}; yielding "
                  f"({describe_exit(EXIT_DEPOSED)})", file=sys.stderr,
                  flush=True)
            return EXIT_DEPOSED
        finally:
            print(f"[elastic] quarantine_hits={self.quarantine.hits} "
                  f"scale_events={self.events}", file=sys.stderr,
                  flush=True)
            self._cleanup()

    def _run(self):
        self._acquire_lease()
        n_local = self.args.local_agents
        if n_local < 0:
            n_local = self.max_nodes
        if n_local:
            self._spawn_local_agents(n_local)
        participants = self._rendezvous()
        if participants is None:
            print(f"[elastic] rendezvous failed: fewer than "
                  f"{self.min_nodes} agents registered within "
                  f"{self.args.elastic_timeout:.0f}s", file=sys.stderr,
                  flush=True)
            return 1
        return self._run_rounds(participants)

    def _run_shadow(self):
        """Shadow coordinator: serve the standby registry, ship the
        primary's op log onto it, watch the primary's lease, and on
        expiry adopt the last published round spec — resuming heartbeat
        supervision of the live agents with NO re-rendezvous and no new
        round (the agents' orphan window is our takeover budget)."""
        grace = float(os.environ.get("PADDLE_TPU_COORD_LEASE_GRACE_S", 0)
                      or 3 * self.args.elastic_ttl)
        lease_key = self._coord_key("lease")
        state_key = self._coord_key("state")
        print(f"[elastic] shadow coordinator standing by "
              f"(lease grace {grace:.0f}s, candidates "
              f"{', '.join(f'{h}:{p}' for h, p in self.eps)})",
              file=sys.stderr, flush=True)
        # lease staleness is measured on OUR monotonic clock since the
        # last observed CHANGE of the lease stamp — never by differencing
        # two hosts' wall clocks, where ordinary NTP skew greater than
        # the grace window would read every fresh lease as expired and
        # depose a healthy primary on sight
        last_ts, fresh_at = None, None
        while True:
            try:
                if self.registry.is_complete():
                    print("[elastic] shadow: job completed under the "
                          "primary coordinator", file=sys.stderr,
                          flush=True)
                    return 0
                lease = json.loads(self.store.get(lease_key).decode()) \
                    if self.store.check(lease_key) else None
            except Exception as e:
                print(f"[elastic] shadow lease read failed: {e}",
                      file=sys.stderr, flush=True)
                time.sleep(0.5)
                continue
            if lease is None:
                time.sleep(0.5)  # primary not up yet
                continue
            ts = lease.get("ts")
            if ts != last_ts or fresh_at is None:
                last_ts, fresh_at = ts, time.monotonic()
            age = time.monotonic() - fresh_at
            if age <= grace:
                time.sleep(min(1.0, self.args.elastic_ttl / 3.0))
                continue
            try:
                raw = self.store.get(state_key) \
                    if self.store.check(state_key) else None
            except Exception:
                raw = None
            if raw is None:
                # lease expired before any round was published: nothing
                # to adopt — keep waiting (the primary may still come up
                # and rendezvous; a dead pre-round primary means the
                # operator restarts the job)
                print("[elastic] shadow: lease stale but no coordinator "
                      "state published yet; waiting", file=sys.stderr,
                      flush=True)
                time.sleep(1.0)
                continue
            state = json.loads(raw.decode())
            break
        # ---- takeover: fence the deposed term, adopt the round
        for sh in self._shippers:
            sh.stop()
        try:
            # our client may have homed on the standby from construction
            # and never failed over — adopt the store's CURRENT fence
            # epoch (the agents' re-home bumped it) or our own first
            # lease publish would depose us under the stale pin
            self.store.adopt_epoch()
        except Exception:
            pass
        self._term = int(self.store.add(self._coord_key("term"), 1))
        self._sweep_term()
        spec = state["spec"]
        self.known = list(state.get("known") or [])
        self.quarantine.restore(state.get("quarantine") or {})
        self.events = int(state.get("events") or 0)
        self.preempt_restarts = int(state.get("preempt_restarts") or 0)
        self.current_spec = spec
        self._failover_at = time.monotonic()  # re-home grace for agents
        self._adopted = True
        print(f"SHADOW_ADOPTED round={spec['round']} term={self._term} "
              f"wall={time.time():.6f}", flush=True)
        print(f"[elastic] shadow adopted round {spec['round']} "
              f"(deposed term {int(state.get('term') or 0)} -> "
              f"{self._term}; lease was {age:.1f}s stale): resuming "
              "supervision of live agents without re-rendezvous",
              file=sys.stderr, flush=True)
        self._publish_lease()
        participants = [nid for nid, _ in
                        sorted(spec["nodes"].items(),
                               key=lambda kv: kv[1])]
        return self._run_rounds(participants, resume_spec=spec)

    def _run_rounds(self, participants, resume_spec=None):
        while True:
            self._domains = FailureDomainMap(participants)
            if resume_spec is not None:
                # adopted from the replicated store: the agents are
                # already running this round — supervise it as-is, never
                # republish (a bumped round number would relaunch every
                # worker for nothing)
                spec, resume_spec = resume_spec, None
                self._publish_coord_state()
            else:
                spec = self._render(
                    participants, self.args.nproc_per_node, self.master,
                    quarantined=self.quarantine.quarantined(),
                    store_inc=self.store.incarnation)
                os.makedirs(self.args.log_dir, exist_ok=True)
                _clear_dumps(self.args.log_dir)
                no = self.registry.publish_round(spec)
                spec["round"] = no
                self.current_spec = spec
                self._publish_coord_state()
                print(f"[elastic] round {no}: "
                      f"nnodes={len(participants)} "
                      f"world_size={spec['world']} nodes={participants} "
                      f"(range {self.min_nodes}:{self.max_nodes})",
                      file=sys.stderr, flush=True)
            outcome, detail = self._watch_round(spec)
            if outcome == "done":
                self.registry.announce_complete()
                print(f"[elastic] all {len(participants)} node(s) "
                      "finished", file=sys.stderr, flush=True)
                _run_report(self.args.log_dir)
                return 0
            if outcome == "preempt":
                self.preempt_restarts += 1
                if self.preempt_restarts > self.args.max_preempt_restarts:
                    print("[launch] preemption resume limit reached",
                          file=sys.stderr, flush=True)
                    return EXIT_PREEMPT
                print(f"[elastic] graceful preemption: relaunching the "
                      f"same {len(participants)} node(s) (preempt resume "
                      f"{self.preempt_restarts}, does not consume "
                      "max_restarts)", file=sys.stderr, flush=True)
                continue
            self.events += 1
            if self.events > self.args.max_elastic_events:
                print("[elastic] scale-event limit reached",
                      file=sys.stderr, flush=True)
                return 1
            if outcome == "scale_out":
                new = (participants + detail)[:self.max_nodes]
                print(f"[elastic] node join {detail}: scaling "
                      f"{len(participants)} -> {len(new)} node(s); new "
                      "round (graceful save + relaunch)",
                      file=sys.stderr, flush=True)
                participants = new
                continue
            # failure: quarantine bookkeeping, then reform from live
            # capacity (failed-but-alive agents rejoin; standbys
            # backfill; lost/quarantined nodes drop out)
            for nid in detail["blamed"]:
                if self.quarantine.record_failure(nid):
                    print(f"[elastic] quarantine node={nid} "
                          f"({self.quarantine.threshold} failures within "
                          f"{self.quarantine.window_s:.0f}s): excluded "
                          "from subsequent rounds", file=sys.stderr,
                          flush=True)
            # checkpoint the quarantine hit NOW, not at the next round
            # publish: a coordinator dying in between must not hand the
            # shadow a ledger that forgot the failure
            self._publish_coord_state()
            survivors = self._live_capacity()[:self.max_nodes]
            print(f"[elastic] node scale event (statuses "
                  f"{detail['statuses']}; blamed {detail['blamed']}): "
                  f"{len(survivors)} node(s) survive",
                  file=sys.stderr, flush=True)
            if len(survivors) < self.min_nodes:
                print(f"[elastic] live nodes {len(survivors)} below "
                      f"min_nnodes={self.min_nodes}: HOLD "
                      f"{self.args.elastic_timeout:.0f}s for joins",
                      file=sys.stderr, flush=True)
                deadline = time.time() + self.args.elastic_timeout
                while time.time() < deadline:
                    self._coord_beat()
                    self._scan_joins()
                    survivors = self._live_capacity()[:self.max_nodes]
                    if len(survivors) >= self.min_nodes:
                        break
                    time.sleep(0.5)
                if len(survivors) < self.min_nodes:
                    print("[elastic] no joins arrived: exiting",
                          file=sys.stderr, flush=True)
                    return detail["rc"]
            participants = survivors

    def _cleanup(self):
        for sh in self._shippers:
            try:
                sh.stop()
            except Exception:
                pass
        # completion (or giving up) must not strand agents: the complete
        # flag is best-effort (the registry may be gone), the SIGTERM
        # sweep is the backstop. Two exceptions own the job elsewhere:
        # a DEPOSED coordinator (the shadow supervises the live agents
        # now — announcing complete or SIGTERMing them would kill a
        # healthy round) and a shadow that never ADOPTED (the primary is
        # still running it).
        yielded = self._deposed or (self.role == "shadow"
                                    and not self._adopted)
        if not yielded:
            try:
                self.registry.announce_complete()
            except Exception:
                pass
            deadline = time.time() + max(5.0, 2 * self.args.elastic_ttl)
            for proc in self.agent_procs:
                while proc.poll() is None and time.time() < deadline:
                    time.sleep(0.1)
            _terminate_survivors([(p, None) for p in self.agent_procs],
                                 self.args.terminate_grace)
        for srv in self.servers:
            try:
                if srv is not None:
                    srv.stop_server()
            except Exception:
                pass


def _launch_node_elastic(args, extra_env, min_nodes, max_nodes):
    if args.watchdog_timeout > 0 \
            and not os.environ.get("PADDLE_TPU_WATCHDOG_TIMEOUT") \
            and "PADDLE_TPU_WATCHDOG_TIMEOUT" not in extra_env:
        # node-elastic jobs always relaunch: a hang must convert into an
        # exit for the scale machinery to see it
        extra_env["PADDLE_TPU_WATCHDOG_TIMEOUT"] = str(
            args.watchdog_timeout)
    return _NodeCoordinator(args, extra_env, min_nodes, max_nodes).run()


def _usage_error(args, msg, hint):
    """Flag-combination failure with a mapped cause + one-line hint —
    and the workerlog dir exists, so post-mortem tooling pointed at
    --log_dir finds a directory, not ENOENT (not a bare ValueError before
    any log dir was created)."""
    os.makedirs(args.log_dir, exist_ok=True)
    print(f"[launch] {msg} ({describe_exit(EXIT_USAGE)})",
          file=sys.stderr, flush=True)
    print(f"[launch] hint: {hint}", file=sys.stderr, flush=True)
    return EXIT_USAGE


def _parse_nnodes(spec):
    """'N' or 'MIN:MAX' -> (min_nodes, max_nodes, is_elastic)."""
    s = str(spec)
    if ":" in s:
        lo, hi = s.split(":")
        return int(lo), int(hi), True
    n = int(s)
    return n, n, False


def launch(argv=None):
    args = _parse_args(argv)
    # worker-only env (never mutate our own os.environ: launch() may run
    # in-process, e.g. from tests)
    extra_env = {}
    if args.max_restarts > 0 and args.watchdog_timeout > 0 \
            and not os.environ.get("PADDLE_TPU_WATCHDOG_TIMEOUT"):
        # restarts only help if a hang converts into an exit first
        extra_env["PADDLE_TPU_WATCHDOG_TIMEOUT"] = \
            str(args.watchdog_timeout)
    if os.environ.get("PADDLE_TPU_FAULTS") \
            and not os.environ.get("PADDLE_TPU_FAULT_LEDGER"):
        os.makedirs(args.log_dir, exist_ok=True)
        extra_env["PADDLE_TPU_FAULT_LEDGER"] = os.path.abspath(
            os.path.join(args.log_dir, "fault_ledger.txt"))

    try:
        min_nodes, max_nodes, node_elastic = _parse_nnodes(args.nnodes)
    except ValueError:
        return _usage_error(
            args, f"--nnodes {args.nnodes!r} is not 'N' or 'MIN:MAX'",
            "fixed multi-host: --nnodes N --node_rank R; node-level "
            "elastic: --nnodes MIN:MAX (this launcher becomes the "
            "coordinator of per-node agents)")
    if args.np_spec and (node_elastic or max_nodes != 1):
        return _usage_error(
            args, f"--np {args.np_spec} cannot combine with "
                  f"--nnodes {args.nnodes}: --np elastic mode drives a "
                  "single-host process group",
            "use --nnodes MIN:MAX (without --np) for multi-host elastic "
            "— node agents become the unit of membership")
    if args.coordinator_role != "auto" and not node_elastic:
        return _usage_error(
            args, f"--coordinator_role {args.coordinator_role} only "
                  "applies to --nnodes MIN:MAX jobs",
            "the primary/shadow pair replicates the node-elastic "
            "control plane; fixed-nnodes jobs have no coordinator")
    if args.coordinator_role != "auto" \
            and len([c for c in args.master.split(",") if c.strip()]) < 2:
        return _usage_error(
            args, f"--coordinator_role {args.coordinator_role} needs a "
                  "standby --master candidate",
            "pass --master host:p1,host:p2 — the second candidate is "
            "the replicated standby registry the shadow serves")
    if node_elastic:
        if min_nodes < 1 or max_nodes < min_nodes:
            return _usage_error(
                args, f"--nnodes {args.nnodes}: need 1 <= MIN <= MAX",
                "example: --nnodes 2:3 --nproc_per_node 2")
        return _launch_node_elastic(args, extra_env, min_nodes, max_nodes)
    args.nnodes = max_nodes  # legacy fixed-nnodes path wants the int

    elastic = None
    cur_np = None
    if args.np_spec:
        elastic = _ElasticState(args)
        cur_np = elastic.max_np  # rendezvous starts at full width
        extra_env.update(elastic.worker_env(args))

    restarts = 0
    preempt_restarts = 0
    spawn_round = 0
    while True:
        names = None
        if elastic is not None:
            names = elastic.round_names(spawn_round, cur_np)
            print(f"[elastic] round {spawn_round}: world_size={cur_np} "
                  f"(range {elastic.min_np}:{elastic.max_np})",
                  file=sys.stderr)
        os.makedirs(args.log_dir, exist_ok=True)
        _clear_dumps(args.log_dir)
        procs = []
        for lr in range(cur_np if elastic is not None
                        else args.nproc_per_node):
            env = dict(extra_env)
            if names is not None:
                env["PADDLE_TPU_ELASTIC_NAME"] = names[lr]
            procs.append(_spawn(args, lr, spawn_round, env,
                                world_np=cur_np))
        rcs, first_bad, event = _wait_any_failure(
            procs,
            on_poll=(elastic.joins if elastic is not None else None),
            settle=(min(1.0, args.terminate_grace)
                    if elastic is not None else 0.0))

        if event:  # scale-OUT: joiners widen the world
            # one join = one scale decision: absorb the names now or the
            # same joiners re-trigger an event every poll forever
            elastic.absorb(event)
            new_np = min(elastic.max_np, cur_np + len(event))
            if new_np == cur_np:
                # absorbed (so the same join can't re-fire every poll)
                # but NOT forgotten: a later worker loss consumes this
                # standby capacity instead of scaling down
                elastic.standby.extend(event)
                print(f"[elastic] join {event} held as standby: already "
                      f"at max_np={elastic.max_np}", file=sys.stderr)
                # the workers are still running: just keep waiting
                rcs, first_bad, _ = _wait_any_failure(procs, settle=1.0)
            else:
                elastic.events += 1
                if elastic.events > args.max_elastic_events:
                    print("[elastic] scale-event limit reached",
                          file=sys.stderr)
                    _terminate_survivors(procs, args.terminate_grace)
                    return 1
                print(f"[elastic] node join {event}: scaling "
                      f"{cur_np} -> {new_np}; SIGTERM current workers "
                      "(graceful save) and relaunching", file=sys.stderr)
                _terminate_survivors(procs, args.terminate_grace)
                cur_np = new_np
                spawn_round += 1
                time.sleep(1)
                continue

        if first_bad is not None and any(rc is None for rc in rcs):
            print("[launch] terminating surviving workers "
                  f"(first failure rc={first_bad[0]})", file=sys.stderr)
            _terminate_survivors(procs, args.terminate_grace)
        if first_bad is None:
            print(f"[launch] all {len(procs)} worker(s) finished")
            _run_report(args.log_dir)
            if elastic is not None:
                try:
                    elastic.manager.complete()
                except Exception:
                    pass
            return 0
        rc, log_path = first_bad
        print(f"[launch] worker failed ({describe_exit(rc)}); "
              f"log: {log_path}", file=sys.stderr)
        _post_mortem(args.log_dir)
        if rc == EXIT_PREEMPT:
            preempt_restarts += 1
            if preempt_restarts > args.max_preempt_restarts:
                print("[launch] preemption resume limit reached",
                      file=sys.stderr)
                return rc
            print(f"[launch] graceful preemption: resuming "
                  f"(preempt resume {preempt_restarts}, does not consume "
                  f"max_restarts)", file=sys.stderr)
        elif rc == EXIT_INTEGRITY:
            # a guard VERDICT, not an infra failure: a relaunch would
            # resume the same snapshot and re-trip the same anomaly —
            # restarting here is the loop EXIT_INTEGRITY exists to break
            print("[launch] training integrity guard exhausted its "
                  "rewind budget: not restarting (a relaunch would "
                  "resume the same snapshot and re-trip)",
                  file=sys.stderr)
            return rc
        elif elastic is not None:
            # scale event: only hard-killed members (rc == -SIGKILL, the
            # lost-host signal) shed capacity.  A peer dying mid-collective
            # takes the survivors down too (gloo broken pipe -> SIGABRT/
            # SIGSEGV inside the settle window) — those are collateral, the
            # capacity is still here and relaunches.  With no hard kill the
            # one causal failure sheds a single member; rc 0 = clean finish
            # and EXIT_PREEMPT = graceful save never shed capacity.
            lost = sum(1 for r in rcs if r == -signal.SIGKILL)
            new_np = cur_np - max(1, lost)
            joiners = elastic.joins()
            elastic.absorb(joiners)
            if elastic.standby:
                # standby capacity (joins that arrived at max_np) backfills
                # the loss — but only nodes still heartbeating
                try:
                    live = set(elastic.manager.hosts())
                except Exception:
                    live = set()
                fresh = [n for n in elastic.standby if n in live]
                elastic.standby = []
                joiners = joiners + fresh
            new_np = min(elastic.max_np, new_np + len(joiners))
            if new_np < elastic.min_np:
                print(f"[elastic] live world {new_np} below min_np="
                      f"{elastic.min_np}: HOLD {args.elastic_timeout:.0f}s "
                      "for joins", file=sys.stderr)
                held = elastic.hold_for_joins(
                    elastic.min_np - new_np, args.elastic_timeout)
                elastic.absorb(held)
                joiners = joiners + held
                new_np = min(elastic.max_np, new_np + len(held))
                if new_np < elastic.min_np:
                    print("[elastic] no joins arrived: exiting",
                          file=sys.stderr)
                    return rc
            elastic.events += 1
            if elastic.events > args.max_elastic_events:
                print("[elastic] scale-event limit reached",
                      file=sys.stderr)
                return rc
            print(f"[elastic] scale event (lost {max(1, lost)}, "
                  f"joined {len(joiners)}): relaunching at "
                  f"world_size={new_np} (does not consume max_restarts)",
                  file=sys.stderr)
            cur_np = new_np
        else:
            if restarts >= args.max_restarts:
                return rc
            restarts += 1
            print(f"[launch] restarting workers "
                  f"({restarts}/{args.max_restarts})", file=sys.stderr)
        spawn_round += 1
        time.sleep(1)


def main():
    sys.exit(launch())


if __name__ == "__main__":
    main()
