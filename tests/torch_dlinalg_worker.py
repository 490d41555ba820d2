"""A JAX-free distributed-linear-algebra chaos worker for the port's
tests: the twin of ``tests/workers/dlinalg_worker.py``, with the same
markers and knobs, on ``paddle_tpu_torch.distributed.dlinalg`` (the CPU;
``PADDLE_TPU_DLA_BACKEND`` picks the backend, ``numpy`` by default).

Runs the resumable subspace-iteration eigensolve on a deterministic
symmetric matrix under the elastic launcher: every incarnation rebuilds
the same A from the seed, reshards the block-cyclic layout to its world
size, restores the newest verified snapshot through CheckpointLineage
and continues from the last committed panel. A self-SIGKILL knob models
losing a host mid-sweep; the store can be a plain TCPStore (rank 0
master) or a FailoverStore client against test-hosted primary/standby
masters.

Markers on stdout (one per line, parsed by the tests):
    WORLD <n>                      world size this incarnation runs at
    FRESH                          no usable snapshot
    RESUMED step=S sweep=W panel=B restored lineage step + solver state
    PANEL <sweep> <panel> <stamp>  one committed panel (wall clock)
    SWEEP <sweep> <resid> <stamp>  one committed sweep + eigen-residual
    SELF_SIGKILL <stamp>           about to SIGKILL self (chaos knob)
    ORACLE_FAIL <what> <value>     a numerical gate tripped (exit 47)
    THETA_ERR <err>                max |theta - numpy eigh| (f64 parity)
    DONE <sweeps> <resid>          converged; final eigen-residual

Env knobs: PADDLE_TPU_CKPT_DIR (required), PADDLE_TPU_FT_STORE_PORT
(TCPStore, rank 0 hosts) or PADDLE_TPU_DLA_STORE_ENDPOINTS (comma list
-> FailoverStore client; masters live elsewhere), PADDLE_TPU_DLA_N /
_P / _BLOCK (problem shape), PADDLE_TPU_DLA_TOL, PADDLE_TPU_DLA_MAX_SWEEPS,
PADDLE_TPU_DLA_SEED, PADDLE_TPU_DLA_SLEEP_S (per-panel compute stretch so
kills land mid-sweep), PADDLE_TPU_DLA_KILL="rank:panels" (SIGKILL self on
that rank after that many committed panels — once per job, tracked by a
marker file in the checkpoint dir).
"""
import os
import signal
import sys
import time

import numpy as np
import torch

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import device
from paddle_tpu_torch.distributed import fault
from paddle_tpu_torch.distributed import dlinalg


def build_matrix(n, p, seed):
    """Deterministic symmetric A with a clean spectral gap: p dominant
    eigenvalues in [2, p+1], the rest in [0, 0.05] — identical on every
    rank and every incarnation (the resume contract's ground truth)."""
    rng = np.random.default_rng(seed)
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    d = np.concatenate([np.linspace(p + 1.0, 2.0, p),
                        np.sort(rng.uniform(0.0, 0.05, n - p))[::-1]])
    return (V * d) @ V.T


def main():
    torch.set_num_threads(1)
    device.DEFAULT_DEVICE = "cpu"
    dist.init_parallel_env()
    world, rank = dist.get_world_size(), dist.get_rank()
    incarnation = int(os.environ.get("PADDLE_TPU_RESTART_NUM", "0"))
    print(f"WORLD {world}", flush=True)

    n = int(os.environ.get("PADDLE_TPU_DLA_N", "96"))
    p = int(os.environ.get("PADDLE_TPU_DLA_P", "4"))
    block = int(os.environ.get("PADDLE_TPU_DLA_BLOCK", "16"))
    tol = float(os.environ.get("PADDLE_TPU_DLA_TOL", "1e-9"))
    max_sweeps = int(os.environ.get("PADDLE_TPU_DLA_MAX_SWEEPS", "60"))
    seed = int(os.environ.get("PADDLE_TPU_DLA_SEED", "5"))
    sleep_s = float(os.environ.get("PADDLE_TPU_DLA_SLEEP_S", "0"))

    store = None
    endpoints = os.environ.get("PADDLE_TPU_DLA_STORE_ENDPOINTS")
    port = os.environ.get("PADDLE_TPU_FT_STORE_PORT")
    if endpoints:
        # WAL-replication variant: the test hosts primary+standby masters
        # and a LogShipper; every worker is a rotating FailoverStore
        # client, so the dlinalg/* panel keys survive the primary's death
        store = dist.FailoverStore(endpoints, world_size=world, timeout=30,
                                   connect_deadline=3.0)
    elif port and world > 1:
        store = dist.TCPStore("127.0.0.1", int(port), is_master=(rank == 0),
                              world_size=world, timeout=60)
    lineage = fault.CheckpointLineage(os.environ["PADDLE_TPU_CKPT_DIR"],
                                      store=store, world_size=world,
                                      rank=rank)

    A_full = build_matrix(n, p, seed)
    A = dlinalg.ShardedMatrix.from_global(A_full, block, world=world,
                                          rank=rank)
    exchange = (dlinalg.StoreExchange(store, job="chaos") if store is not None
                else dlinalg.LocalExchange())
    spec = dlinalg.SweepSpec(n, p, block_rows=block, seed=seed, tol=tol,
                             max_sweeps=max_sweeps, checkpoint_panels=True,
                             panel_sleep_s=sleep_s, backend=os.environ.get(
                                 "PADDLE_TPU_DLA_BACKEND", "numpy"))
    solver = dlinalg.SubspaceEigensolver(A, spec, exchange, lineage=lineage,
                                         job="chaos")
    # Fence restore() across ranks: unlike the TCPStore path (where every
    # client blocks until the rank-0-hosted master binds), FailoverStore
    # clients come up independently, so without a barrier one rank can
    # finish restoring and start SAVING step N while a peer is still
    # inside load_latest — whose rank-0 GC would rmtree the half-written
    # "torn" snapshot out from under the saver.
    if store is not None and world > 1:
        exchange.barrier(f"start/i{incarnation}", world, timeout=120)
    step = solver.restore()
    if store is not None and world > 1:
        exchange.barrier(f"restored/i{incarnation}", world, timeout=120)
    if step is None:
        print("FRESH", flush=True)
    else:
        print(f"RESUMED step={step} sweep={solver.sweep} "
              f"panel={solver.panel}", flush=True)

    kill = os.environ.get("PADDLE_TPU_DLA_KILL", "")
    kill_rank = kill_after = None
    if kill:
        kr, ka = kill.split(":")
        kill_rank, kill_after = int(kr), int(ka)
    kill_marker = os.path.join(os.environ["PADDLE_TPU_CKPT_DIR"],
                               "chaos_killed.marker")
    committed = 0

    def on_panel(s, b):
        nonlocal committed
        committed += 1
        print(f"PANEL {s} {b} {time.time():.6f}", flush=True)
        if (kill_rank == rank and committed == kill_after
                and not os.path.exists(kill_marker)):
            with open(kill_marker, "w") as f:
                f.write(f"i{incarnation} s{s} b{b}\n")
            print(f"SELF_SIGKILL {time.time():.6f}", flush=True)
            sys.stdout.flush()
            os.kill(os.getpid(), signal.SIGKILL)

    def on_sweep(s, resid):
        print(f"SWEEP {s} {resid:.6e} {time.time():.6f}", flush=True)

    try:
        theta, X, converged = solver.run(on_panel=on_panel,
                                         on_sweep=on_sweep)
    except dlinalg.OracleViolation as e:
        print(f"ORACLE_FAIL {e.what} {e.value:.6e}", flush=True)
        sys.exit(fault.EXIT_ORACLE)

    ref = np.linalg.eigvalsh(A_full)[::-1][:p]
    err = float(np.max(np.abs(theta - ref)) / np.max(np.abs(ref)))
    print(f"THETA_ERR {err:.6e}", flush=True)
    resid = solver.residual_history[-1]
    # drain in lockstep before any rank (possibly the store master) exits
    if store is not None and world > 1:
        exchange.barrier(f"exit/i{incarnation}", world, timeout=60)
    print(f"DONE {solver.sweep} {resid:.6e}", flush=True)
    sys.exit(0)


if __name__ == "__main__":
    main()
