"""The single-host launcher, after ``paddle_tpu/distributed/launch/
main.py`` (reference: launch/main.py + controllers/collective.py).

``python -m paddle_tpu_torch.distributed.launch --nproc_per_node N
[--max_restarts R] [--log_dir D] script.py args...`` starts N worker
processes of one host, each with the JAX launcher's environment
(``PADDLE_TPU_PROCESS_ID``, ``PADDLE_TPU_NUM_PROCESSES``,
``PADDLE_TPU_RESTART_NUM``, ``PADDLE_TRAINER_ID`` /
``PADDLE_TRAINERS_NUM``, ``PADDLE_TPU_WORKERLOG_DIR``, and the import
path of the checkout that holds ``paddle_tpu_torch``), its log in
``<log_dir>/workerlog.<rank>[.restart<n>]``.

Fault-tolerance contract (``distributed/fault.py``):

- Workers are POLLED concurrently; on the first nonzero exit the
  survivors are terminated (SIGTERM, then SIGKILL after a grace period)
  before restarting — a dead peer must not leave the rest blocked
  forever inside a collective.
- Exit code ``EXIT_PREEMPT`` (75) marks a graceful-preemption save: the
  job is relaunched WITHOUT consuming ``--max_restarts`` (bounded only
  by ``--max_preempt_restarts`` as a runaway guard).
- With ``--max_restarts > 0`` the per-step watchdog is armed by default
  (``PADDLE_TPU_WATCHDOG_TIMEOUT`` forwarded to workers, override or
  set 0 to disable): a hung step converts into an escalated abort
  (flight-recorder dump + blame, exit 19; native exit-17 backstop) and
  thus a restart instead of a stuck job. Worker exit codes are mapped to
  causes via ``fault.describe_exit``; after any failure the launcher
  prints a per-rank flight-recorder post-mortem when dumps exist in
  ``--log_dir`` and the run report of the workers' metrics.
- ``EXIT_INTEGRITY`` (49, the integrity guard's verdict) is not
  restarted: a relaunch would resume the same snapshot and re-trip.
- When ``PADDLE_TPU_FAULTS`` is set, a fault ledger file under
  ``--log_dir`` is exported so deterministic injections fire once per
  job, not once per incarnation.

Not ported yet, and refused with ``NotImplementedError``: the elastic
paths (``--np MIN:MAX`` and ``--nnodes`` other than 1, with the node
agents and the coordinator), which come with ROADMAP Queue 1 item 6's
elastic part.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

from ..fault import EXIT_INTEGRITY, EXIT_PREEMPT, describe_exit

__all__ = ["launch", "main"]

# the checkout that holds the paddle_tpu_torch package: workers must be
# able to import it whatever their script's directory
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

_ELASTIC = ("the elastic launcher (--np MIN:MAX, --nnodes and the node "
            "agents) is not ported yet (ROADMAP Queue 1 item 6, its "
            "elastic part)")


def _parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="launch a single-host paddle_tpu_torch training job")
    p.add_argument("--nnodes", default="1",
                   help="number of hosts; only 1 is ported (the elastic "
                        "'MIN:MAX' form and multi-host raise)")
    p.add_argument("--master", default=os.environ.get(
        "PADDLE_TPU_COORDINATOR", "127.0.0.1:8476"),
        help="coordinator address host:port, exported to workers as "
             "PADDLE_TPU_COORDINATOR when there is more than one")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="processes per host (one per card)")
    p.add_argument("--np", default=None, dest="np_spec", metavar="MIN:MAX",
                   help="elastic world-size range (not ported yet: raises)")
    p.add_argument("--log_dir", default="log", help="per-rank log directory")
    p.add_argument("--max_restarts", type=int, default=0,
                   help="relaunch failed workers up to N times")
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


def _spawn(args, local_rank, restart_count, extra_env=None):
    """Spawn one worker of this host's job."""
    global_rank, world = local_rank, args.nproc_per_node
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


def _wait_any_failure(procs, poll_interval=0.2):
    """Poll ALL workers concurrently; return (rcs, first_bad) where
    first_bad is (rc, log_path) of the earliest observed failure (None if
    every worker exited 0). A sequential ``proc.wait()`` loop would block
    on worker 0 while a crashed peer left the survivors hung in
    collectives forever."""
    rcs = [None] * len(procs)
    first_bad = None
    while any(rc is None for rc in rcs):
        for i, (proc, log_path) in enumerate(procs):
            if rcs[i] is None:
                rc = proc.poll()
                if rc is not None:
                    rcs[i] = rc
                    if rc != 0 and first_bad is None:
                        first_bad = (rc, log_path)
        if first_bad is not None and any(rc is None for rc in rcs):
            return rcs, first_bad
        if any(rc is None for rc in rcs):
            time.sleep(poll_interval)
    return rcs, first_bad


def launch(argv=None):
    args = _parse_args(argv)
    if args.np_spec or str(args.nnodes) != "1":
        raise NotImplementedError(_ELASTIC)
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

    restarts = 0
    preempt_restarts = 0
    spawn_round = 0
    while True:
        os.makedirs(args.log_dir, exist_ok=True)
        _clear_dumps(args.log_dir)
        procs = [_spawn(args, lr, spawn_round, extra_env)
                 for lr in range(args.nproc_per_node)]
        rcs, first_bad = _wait_any_failure(procs)
        if first_bad is not None and any(rc is None for rc in rcs):
            print("[launch] terminating surviving workers "
                  f"(first failure rc={first_bad[0]})", file=sys.stderr)
            _terminate_survivors(procs, args.terminate_grace)
        if first_bad is None:
            print(f"[launch] all {len(procs)} worker(s) finished")
            _run_report(args.log_dir)
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
            # resume the same snapshot and re-trip the same anomaly
            print("[launch] training integrity guard exhausted its "
                  "rewind budget: not restarting (a relaunch would "
                  "resume the same snapshot and re-trip)",
                  file=sys.stderr)
            return rc
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
