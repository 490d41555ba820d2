"""The port's fault-tolerant distributed linear algebra
(``paddle_tpu_torch.distributed.dlinalg``) on the CPU: twins of the cases
of ``tests/test_dlinalg.py`` (all but its ``bench.py`` leg-guard case:
the port has no benchmark yet) and of the two chaos runs of
``tests/test_dlinalg_chaos.py`` (``slow``, as in JAX), and parity with
the JAX package's ``dlinalg`` on the same numpy inputs: the numpy
backend bit-equal, the device backend (``xla``: torch in float64, on the
CPU as these tests ask) within 1e-12 of JAX's numpy results, and an
eigensolve snapshot that either package wrote resuming in the other to
the right answer.

The multi-rank fast tier simulates SPMD with one thread per rank over a
shared LocalExchange; the chaos runs start
``tests/torch_dlinalg_worker.py`` under the port's launcher.
"""
import os
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from paddle_tpu.distributed import dlinalg as jdl
from paddle_tpu.distributed import fault as jfault

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import device as port_device
from paddle_tpu_torch.distributed import dlinalg, fault, keyspace
from paddle_tpu_torch.distributed.dlinalg import (
    BlockCyclicLayout, ExchangeTimeout, LocalExchange, ShardedMatrix,
    StoreExchange, SubspaceEigensolver, SweepSpec, OracleViolation,
    ResidualOracle, blocked_qr, matmul_reference, qr_reference,
    summa_matmul, tsqr,
)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORKER = os.path.join(TESTS, "torch_dlinalg_worker.py")


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _read_worker_logs(log_dir, rank):
    import glob
    text = ""
    for p in sorted(glob.glob(os.path.join(log_dir, f"workerlog.{rank}*"))):
        with open(p) as f:
            text += f.read()
    return text


@pytest.fixture(autouse=True)
def _clean_fault_state(monkeypatch):
    """No fault spec, ledger or preemption flag in or out of a case (both
    packages), and the device backend on the CPU."""
    monkeypatch.delenv("PADDLE_TPU_FAULTS", raising=False)
    monkeypatch.delenv("PADDLE_TPU_FAULT_LEDGER", raising=False)
    monkeypatch.setattr(port_device, "DEFAULT_DEVICE", "cpu")
    for f in (fault, jfault):
        f.set_fault_spec(None)
        f._preempt_event.clear()
    yield
    for f in (fault, jfault):
        f.set_fault_spec(None)
        f._preempt_event.clear()


def run_spmd(world, fn, timeout=120, exchange=LocalExchange):
    """Run ``fn(rank, exchange)`` on one thread per rank over a shared
    exchange; returns the per-rank results (re-raises the first
    failure)."""
    ex = exchange()
    results = [None] * world
    errors = []

    def target(r):
        try:
            results[r] = fn(r, ex)
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errors.append((r, e))

    threads = [threading.Thread(target=target, args=(r,), daemon=True)
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), "SPMD thread hung"
    if errors:
        raise errors[0][1]
    return results


# ---------------------------------------------------------------- layout

def test_block_cyclic_layout_ownership():
    lay = BlockCyclicLayout(100, 16, world=3)
    assert lay.n_blocks == 7
    assert [lay.owner(b) for b in range(7)] == [0, 1, 2, 0, 1, 2, 0]
    assert lay.blocks_of(0) == (0, 3, 6)
    assert lay.row_range(6) == (96, 100)  # ragged tail block
    assert lay.block_nrows(6) == 4
    # every row is covered exactly once
    rows = [r for b in range(lay.n_blocks)
            for r in range(*lay.row_range(b))]
    assert rows == list(range(100))
    with pytest.raises(ValueError):
        BlockCyclicLayout(0, 16)
    with pytest.raises(ValueError):
        BlockCyclicLayout(100, 16, world=0)


def test_layout_reshard_is_metadata_only():
    """The block COUNT is world-independent: resharding changes only
    ownership, and reshard_moves names exactly the blocks that move."""
    old = BlockCyclicLayout(100, 16, world=3)
    new = old.reshard(2)
    assert new.n_blocks == old.n_blocks
    moves = old.reshard_moves(new)
    for b, old_owner, new_owner in moves:
        assert old.owner(b) == old_owner != new.owner(b) == new_owner
    moved = {b for b, _, _ in moves}
    for b in range(old.n_blocks):
        assert (b in moved) == (old.owner(b) != new.owner(b))
    with pytest.raises(ValueError):
        old.reshard_moves(BlockCyclicLayout(100, 8, world=2))


def test_sharded_matrix_round_trip():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((50, 7))
    m = ShardedMatrix.from_global(a, 8, world=1, rank=0)
    assert np.array_equal(m.to_global(), a)
    # sharded across a world: each rank holds exactly its blocks
    shards = [ShardedMatrix.from_global(a, 8, world=3, rank=r)
              for r in range(3)]
    for r, m in enumerate(shards):
        assert set(m.blocks) == set(m.layout.blocks_of(r))
        for b in m.owned:
            lo, hi = m.layout.row_range(b)
            assert np.array_equal(m.block(b), a[lo:hi])
    with pytest.raises(ValueError):
        shards[0].set_block(1, np.zeros((8, 7)))  # rank 1's block
    with pytest.raises(ValueError):
        shards[0].set_block(0, np.zeros((3, 7)))  # wrong shape


# ---------------------------------------------------------------- matmul

def test_summa_matmul_parity_world3():
    rng = np.random.default_rng(1)
    a, b = rng.standard_normal((60, 40)), rng.standard_normal((40, 9))
    ref = matmul_reference(a, b)

    def body(rank, ex):
        A = ShardedMatrix.from_global(a, 16, world=3, rank=rank)
        B = ShardedMatrix.from_global(b, 16, world=3, rank=rank)
        C = summa_matmul(A, B, ex)
        return C.gather_global(ex, "c")

    for got in run_spmd(3, body):
        assert np.allclose(got, ref, atol=1e-12)
        # f64 accumulation in global block order: parity is BITWISE vs
        # the single-rank run of the same kernel
    solo = summa_matmul(ShardedMatrix.from_global(a, 16),
                        ShardedMatrix.from_global(b, 16),
                        LocalExchange()).to_global()
    assert np.array_equal(solo, got)


def test_summa_matmul_xla_backend_parity():
    """The device backend (``xla``; torch on the CPU here, as the caller
    set it) computes in float64, where JAX's computes in the session's
    dtype: parity with the numpy reference is f64-tight. This pins the
    deviation."""
    rng = np.random.default_rng(2)
    a, b = rng.standard_normal((24, 16)), rng.standard_normal((16, 5))
    C = summa_matmul(ShardedMatrix.from_global(a, 8),
                     ShardedMatrix.from_global(b, 8),
                     LocalExchange(), backend="xla")
    assert C.to_global().dtype == np.float64
    assert np.allclose(C.to_global(), matmul_reference(a, b),
                       rtol=0, atol=1e-12)


def test_summa_resume_mid_round_bit_identical():
    """stop_round checkpoints a partial product; resuming with the saved
    C and start_round reproduces the uninterrupted result BITWISE."""
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((40, 40)), rng.standard_normal((40, 6))
    A = ShardedMatrix.from_global(a, 8)
    B = ShardedMatrix.from_global(b, 8)
    full = summa_matmul(A, B, LocalExchange()).to_global()
    part = summa_matmul(A, B, LocalExchange(), stop_round=2)
    resumed = summa_matmul(A, B, LocalExchange(), start_round=2, C=part)
    assert np.array_equal(resumed.to_global(), full)


def test_freivalds_oracle_passes_and_catches_corruption():
    rng = np.random.default_rng(4)
    a, b = rng.standard_normal((30, 20)), rng.standard_normal((20, 4))
    A = ShardedMatrix.from_global(a, 8)
    B = ShardedMatrix.from_global(b, 8)
    C = summa_matmul(A, B, LocalExchange())
    oracle = ResidualOracle()
    oracle.freivalds_matmul(A, B, C, LocalExchange(), "fv_ok")
    C.block(0)[0, 0] += 1e-3  # silent corruption
    with pytest.raises(OracleViolation) as ei:
        oracle.freivalds_matmul(A, B, C, LocalExchange(), "fv_bad")
    assert ei.value.what == "matmul_freivalds"
    assert any(w == "matmul_freivalds" for w, _ in oracle.history)


# ---------------------------------------------------------------- QR

def test_tsqr_parity_and_replicated_r():
    rng = np.random.default_rng(5)
    y = rng.standard_normal((70, 6))
    qref, rref = qr_reference(y)

    def body(rank, ex):
        Y = ShardedMatrix.from_global(y, 16, world=3, rank=rank)
        Q, R = tsqr(Y, ex)
        return Q.gather_global(ex, "q"), R

    out = run_spmd(3, body)
    # R is replicated bit-identically (every rank factors the same
    # stacked bytes); Q/R match the sign-fixed numpy reference
    assert np.array_equal(out[0][1], out[1][1])
    assert np.array_equal(out[1][1], out[2][1])
    for q, r in out:
        assert np.allclose(r, rref, atol=1e-12)
        assert np.allclose(q, qref, atol=1e-12)
        assert np.allclose(q.T @ q, np.eye(6), atol=1e-13)
        assert np.allclose(q @ r, y, atol=1e-12)


def test_blocked_qr_parity_and_resume():
    rng = np.random.default_rng(6)
    a = rng.standard_normal((64, 12))
    qref, rref = qr_reference(a)

    def body_full(rank, ex):
        mine = ShardedMatrix.from_global(a, 8, world=2, rank=rank)
        return blocked_qr(mine, ex, panel_cols=4,
                          oracle=ResidualOracle())

    full = run_spmd(2, body_full)
    # parity vs the sign-fixed reference (assemble from both ranks)
    got = np.zeros((64, 12))
    for q, _ in full:
        for b in q.owned:
            lo, hi = q.layout.row_range(b)
            got[lo:hi] = q.block(b)
    assert np.allclose(got, qref, atol=1e-11)
    assert np.array_equal(full[0][1], full[1][1])  # replicated R
    assert np.allclose(full[0][1], rref, atol=1e-11)

    # resume: capture the state committed after panel 1, restart at 2
    # (interrupt by raising from on_panel — the chaos model minus the
    # process boundary)
    class _Stop(Exception):
        pass

    saved = {}

    def body_first_half(rank, ex):
        mine = ShardedMatrix.from_global(a, 8, world=2, rank=rank)

        def cap(j, Q, R):
            saved[rank] = ({b: Q.block(b).copy() for b in Q.owned},
                           R.copy())
            if j == 1:
                raise _Stop()
        try:
            blocked_qr(mine, ex, panel_cols=4, on_panel=cap)
        except _Stop:
            pass

    run_spmd(2, body_first_half)

    def body_resume(rank, ex):
        mine = ShardedMatrix.from_global(a, 8, world=2, rank=rank)
        blocks, R = saved[rank]
        Q0 = ShardedMatrix(mine.layout, 12, rank, blocks=blocks)
        return blocked_qr(mine, ex, panel_cols=4, start_panel=2,
                          Q=Q0, R=R.copy(), oracle=ResidualOracle())

    resumed = run_spmd(2, body_resume)
    # bit-identical continuation: projections read only committed state
    for rank in (0, 1):
        assert np.array_equal(resumed[rank][1], full[rank][1])
        for b in resumed[rank][0].owned:
            assert np.array_equal(resumed[rank][0].block(b),
                                  full[rank][0].block(b))


def test_blocked_qr_oracle_catches_injected_corruption():
    fault.set_fault_spec("panel_corrupt@linalg_panel:2")
    rng = np.random.default_rng(7)
    a = rng.standard_normal((32, 8))
    A = ShardedMatrix.from_global(a, 8)
    with pytest.raises(OracleViolation):
        blocked_qr(A, LocalExchange(), panel_cols=4,
                   oracle=ResidualOracle())


# ---------------------------------------------------------------- sweeps

def _test_matrix(n, p, seed=11):
    rng = np.random.default_rng(seed)
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    d = np.concatenate([np.linspace(p + 1.0, 2.0, p),
                        np.sort(rng.uniform(0.0, 0.05, n - p))[::-1]])
    return (V * d) @ V.T


def test_subspace_eigensolver_matches_numpy():
    n, p = 48, 3
    a = _test_matrix(n, p)
    A = ShardedMatrix.from_global(a, 8)
    spec = SweepSpec(n, p, block_rows=8, tol=1e-9, max_sweeps=60)
    solver = SubspaceEigensolver(A, spec, LocalExchange())
    theta, X, converged = solver.run()
    assert converged
    ref = np.linalg.eigvalsh(a)[::-1][:p]
    assert np.allclose(theta, ref, rtol=1e-8)
    # Ritz vectors: A X ~= X diag(theta)
    assert np.allclose(a @ X, X * theta, atol=1e-6)
    assert solver.residual_history[-1] < 1e-9


def test_subspace_eigensolver_world_parity():
    """Within one world every rank ends BIT-IDENTICAL (rank-ordered
    deterministic reductions + replicated host eigh); across world
    sizes the answer agrees to round-off (TSQR stacks rows per rank, so
    f64 association — not the result — depends on the world)."""
    n, p = 48, 3
    a = _test_matrix(n, p)
    spec = dict(block_rows=8, tol=1e-9, max_sweeps=60)
    solo = SubspaceEigensolver(
        ShardedMatrix.from_global(a, 8), SweepSpec(n, p, **spec),
        LocalExchange())
    t1, x1, c1 = solo.run()

    def body(rank, ex):
        A = ShardedMatrix.from_global(a, 8, world=3, rank=rank)
        s = SubspaceEigensolver(A, SweepSpec(n, p, **spec), ex)
        return s.run()

    out = run_spmd(3, body)
    for theta, X, converged in out:
        assert converged == c1
        # cross-rank: bitwise; cross-world: exact answer, f64 round-off
        assert np.array_equal(theta, out[0][0])
        assert np.array_equal(X, out[0][1])
        assert np.allclose(theta, t1, rtol=1e-12)
        assert np.allclose(X, x1, atol=1e-9)


def test_subspace_eigensolver_resume_bit_identical(tmp_path):
    """Interrupt mid-sweep (after a committed panel), restore from the
    lineage in a NEW solver, finish: theta/X match the uninterrupted run
    bitwise and the residual history is stitched, not restarted."""
    n, p = 48, 3
    a = _test_matrix(n, p)

    def fresh(lineage=None):
        A = ShardedMatrix.from_global(a, 8)
        spec = SweepSpec(n, p, block_rows=8, tol=1e-9, max_sweeps=60,
                         checkpoint_panels=True)
        return SubspaceEigensolver(A, spec, LocalExchange(),
                                   lineage=lineage)

    base = fresh()
    t_ref, x_ref, c_ref = base.run()

    lineage = fault.CheckpointLineage(str(tmp_path / "ck"))

    class _Boom(Exception):
        pass

    def bomb(s, b):
        if s == 2 and b == 1:
            raise _Boom()

    victim = fresh(lineage)
    assert victim.restore() is None  # nothing saved yet
    with pytest.raises(_Boom):
        victim.run(on_panel=bomb)

    heir = fresh(lineage)
    step = heir.restore()
    assert step is not None and heir.sweep == 2 and heir.panel == 2
    t2, x2, c2 = heir.run()
    assert c2 == c_ref
    assert np.array_equal(t2, t_ref)
    assert np.array_equal(x2, x_ref)
    assert heir.residual_history == base.residual_history

    # seed mismatch = different problem: restore must refuse, loudly
    A = ShardedMatrix.from_global(a, 8)
    other = SubspaceEigensolver(
        A, SweepSpec(n, p, block_rows=8, seed=99, checkpoint_panels=True),
        LocalExchange(), lineage=lineage)
    with pytest.raises(ValueError, match="RNG spec"):
        other.restore()


def test_subspace_eigensolver_oracle_catches_corruption():
    fault.set_fault_spec("panel_corrupt@linalg_panel:3")
    n, p = 48, 3
    A = ShardedMatrix.from_global(_test_matrix(n, p), 8)
    solver = SubspaceEigensolver(
        A, SweepSpec(n, p, block_rows=8, max_sweeps=10), LocalExchange())
    with pytest.raises(OracleViolation) as ei:
        solver.run()
    assert "panel_residual" in ei.value.what


# ---------------------------------------------------------------- fault

def test_dlinalg_fault_kinds_parse_and_validate():
    es = fault.parse_fault_spec(
        "panel_corrupt@linalg_panel:2,sweep_stall@linalg_sweep:1,"
        "panel_corrupt:1")
    assert [e.key() for e in es] == [
        "panel_corrupt@linalg_panel:2", "sweep_stall@linalg_sweep:1",
        "panel_corrupt:1"]
    # wildcard cooperative kinds only fire at their honored site
    assert es[2].matches("linalg_panel", None)
    assert not es[2].matches("step", None)
    # pinned to a site that can't enact them: rejected at PARSE time
    with pytest.raises(ValueError):
        fault.parse_fault_spec("panel_corrupt@route:1")
    with pytest.raises(ValueError):
        fault.parse_fault_spec("sweep_stall@step:1")


def test_sweep_stall_executes_bounded_sleep(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FAULT_SWEEP_STALL_S", "0.2")
    fault.set_fault_spec("sweep_stall@linalg_sweep:1")
    t0 = time.monotonic()
    # executed kind (like slow_io): the sleep happens HERE, no caller
    # cooperation needed, so maybe_inject returns None
    assert fault.maybe_inject("linalg_sweep") is None
    assert time.monotonic() - t0 >= 0.2
    # trigger burned: the next sweep boundary is clean
    t0 = time.monotonic()
    assert fault.maybe_inject("linalg_sweep") is None
    assert time.monotonic() - t0 < 0.1


def test_exit_causes_audit():
    """Every EXIT_* constant has a human cause in EXIT_CAUSES
    and the codes are pairwise distinct (the launcher's failure summary
    and the chaos tests both key on them)."""
    codes = {name: getattr(fault, name) for name in dir(fault)
             if name.startswith("EXIT_") and name != "EXIT_CAUSES"
             and isinstance(getattr(fault, name), int)}
    assert len(set(codes.values())) == len(codes), codes
    for name, rc in codes.items():
        assert rc in fault.EXIT_CAUSES, f"{name} has no EXIT_CAUSES entry"
        assert fault.EXIT_CAUSES[rc].strip()
    assert fault.EXIT_ORACLE == 47
    assert "oracle" in fault.describe_exit(fault.EXIT_ORACLE)


def test_preemption_scope_installs_and_restores():
    """The scoped SIGTERM watcher restores the previous
    disposition/callback/flag on exit, and nests."""
    seen = []
    prev = signal.getsignal(signal.SIGTERM)
    with fault.preemption_scope() as scope:
        assert scope.installed
        assert not scope.preempted()
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(100):
            if scope.preempted():
                break
            time.sleep(0.01)
        assert scope.preempted()
        # nested scope sees a clean slate-restoring stack
        with fault.preemption_scope(on_preempt=lambda: seen.append(1)):
            pass
        assert scope.preempted()  # outer flag survived the inner scope
    assert not fault.preempted()  # scope exit cleared the flag it owned
    assert signal.getsignal(signal.SIGTERM) == prev
    assert not seen  # inner callback never fired


@pytest.mark.slow
def test_sigterm_mid_sweep_saves_and_exits_75(tmp_path):
    """SIGTERM a single-process sweep mid-run →
    verified snapshot on disk + EXIT_PREEMPT, and a rerun RESUMES from
    it and converges to the right answer."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PADDLE_TPU_", "PADDLE_TRAINER"))}
    env.update({
        "PYTHONPATH": REPO,
        "PYTHONUNBUFFERED": "1",
        "PADDLE_TPU_CKPT_DIR": str(tmp_path / "ck"),
        "PADDLE_TPU_DLA_N": "64", "PADDLE_TPU_DLA_P": "3",
        "PADDLE_TPU_DLA_BLOCK": "8",
        "PADDLE_TPU_DLA_SLEEP_S": "0.2",
    })
    proc = subprocess.Popen(
        [sys.executable, WORKER],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=REPO)
    lines = []
    for line in proc.stdout:
        lines.append(line)
        if line.startswith("PANEL"):
            proc.send_signal(signal.SIGTERM)
            break
    out_rest, err = proc.communicate(timeout=120)
    lines.append(out_rest)
    assert proc.returncode == fault.EXIT_PREEMPT, \
        f"rc={proc.returncode}\n{''.join(lines)}\n{err}"

    # the snapshot it left is VERIFIED loadable (not torn)
    lineage = fault.CheckpointLineage(str(tmp_path / "ck"))
    lay = dlinalg.BlockCyclicLayout(64, 8, world=1)
    target = {"sweep": 0, "panel": 0, "seed": 0, "world": 0,
              "resid_history": [], "theta": None, "Q": None,
              "Y": {f"b{b}": None for b in lay.blocks_of(0)}}
    step = lineage.load_latest(target)
    assert step is not None and step >= 1

    # rerun: resumes (not FRESH) and converges to the true spectrum
    r = subprocess.run(
        [sys.executable, WORKER],
        env={**env, "PADDLE_TPU_DLA_SLEEP_S": "0"}, capture_output=True,
        text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "RESUMED step=" in r.stdout and "FRESH" not in r.stdout
    assert "DONE" in r.stdout
    theta_err = float(r.stdout.split("THETA_ERR ")[1].split()[0])
    assert theta_err < 1e-6


# ---------------------------------------------------------------- keyspace

def test_keyspace_functions_round_trip():
    """Every public key function produces its documented spelling
    (the wire bytes are the protocol — a drifted spelling silently
    splits the namespace)."""
    cases = {
        keyspace.wal_entry(7): "__wal/7",
        keyspace.wal_claim("op1"): "__wal/claim/op1",
        keyspace.wal_result("op1"): "__wal/result/op1",
        keyspace.wal_cursor(2): "__wal/cursor/2",
        keyspace.fence_promo(3): "__fence/promo/e3",
        keyspace.elastic_job("j"): "elastic/j",
        keyspace.elastic_node("j"): "elastic/j/node",
        keyspace.elastic_coord("j"): "elastic/j/coord",
        keyspace.fleet_registry("j"): "serving/j",
        keyspace.fleet_engine_rpc("j", "e1"): "serving/j/eng/e1",
        keyspace.fleet_engine_stream("j", "e1"): "serving/j/eng/e1/stream",
        keyspace.fleet_quarantine("j"): "serving/j/quarantine",
        keyspace.fleet_autoscale("j"): "serving/j/autoscale",
        keyspace.fleet_ledger("j"): "serving/j/ledger",
        keyspace.fleet_router("j"): "serving/j/router",
        keyspace.page_share("j"): "pshare/j",
        keyspace.rpc_worker("w"): "rpc/worker/w",
        keyspace.rpc_rank(4): "rpc/rank/4",
        keyspace.dlinalg_job("j"): "dlinalg/j",
        keyspace.dlinalg_panels("j"): "dlinalg/j/panel",
        keyspace.dlinalg_solver("j"): "dlinalg/j/solver",
    }
    for got, want in cases.items():
        assert got == want
    # __all__ is the audit surface: every function above is exported
    for name in ("dlinalg_job", "dlinalg_panels", "dlinalg_solver"):
        assert name in keyspace.__all__
    # every dlinalg key is registry scope (no ``__`` prefix): it must
    # ride the FailoverStore WAL, not skip it
    for k in (keyspace.dlinalg_job("j"), keyspace.dlinalg_panels("j"),
              keyspace.dlinalg_solver("j")):
        assert not k.startswith("__")


# ---------------------------------------------------------------- exchange

def test_store_exchange_round_trip_and_timeout():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    store = dist.TCPStore("127.0.0.1", port, is_master=True, timeout=15)
    try:
        ex = StoreExchange(store, job="t")
        arr = np.arange(12, dtype=np.float64).reshape(3, 4) / 7.0
        ex.publish("i0/s0/x", arr)
        got = ex.fetch("i0/s0/x", timeout=5)
        assert got.dtype == np.float64 and np.array_equal(got, arr)
        # non-f64 dtypes survive the pack/unpack header too
        ex.publish("i0/s0/y", np.array([[1, 2]], dtype=np.int32))
        assert ex.fetch("i0/s0/y").dtype == np.int32
        # keys live under the keyspace functions' prefixes
        raw = store.get(keyspace.dlinalg_panels("t") + "/i0/s0/x")
        assert raw is not None
        with pytest.raises(ExchangeTimeout):
            ex.fetch("i0/s0/missing", timeout=0.3)
        ex.barrier("done", 1, timeout=5)
        # reduce_sum over one rank is the identity
        assert np.array_equal(
            ex.reduce_sum("i0/s0/r", 0, 1, arr), arr)
    finally:
        store.stop_server()


def test_local_exchange_poll_hook_aborts_blocked_fetch():
    """The poll hook runs while a fetch waits — a preempted rank blocked
    on a dead peer's panel still drains instead of hanging."""
    ex = LocalExchange()

    class _Drain(Exception):
        pass

    calls = []

    def poll():
        calls.append(1)
        if len(calls) >= 3:
            raise _Drain()

    ex.poll = poll
    with pytest.raises(_Drain):
        ex.fetch("never", timeout=10)
    assert len(calls) >= 3




# ------------------------------------------------- parity with JAX's dlinalg
def _both(fn):
    """``fn(pkg)`` for the port's dlinalg and JAX's."""
    return fn(dlinalg), fn(jdl)


def _summa(pkg, world=3, backend="numpy"):
    rng = np.random.default_rng(1)
    a, b = rng.standard_normal((60, 40)), rng.standard_normal((40, 9))

    def body(rank, ex):
        A = pkg.ShardedMatrix.from_global(a, 16, world=world, rank=rank)
        B = pkg.ShardedMatrix.from_global(b, 16, world=world, rank=rank)
        return pkg.summa_matmul(A, B, ex, backend=backend).gather_global(
            ex, "c")
    return run_spmd(world, body, exchange=pkg.LocalExchange)[0]


def _tsqr(pkg, world=3, backend="numpy"):
    y = np.random.default_rng(5).standard_normal((70, 6))

    def body(rank, ex):
        Y = pkg.ShardedMatrix.from_global(y, 16, world=world, rank=rank)
        Q, R = pkg.tsqr(Y, ex, backend=backend)
        return np.concatenate([Q.gather_global(ex, "q"), R])
    return run_spmd(world, body, exchange=pkg.LocalExchange)[0]


def _blocked_qr(pkg, world=2, backend="numpy"):
    a = np.random.default_rng(6).standard_normal((64, 12))

    def body(rank, ex):
        mine = pkg.ShardedMatrix.from_global(a, 8, world=world, rank=rank)
        Q, R = pkg.blocked_qr(mine, ex, panel_cols=4, backend=backend,
                              oracle=pkg.ResidualOracle())
        return np.concatenate([Q.gather_global(ex, "q"), R])
    return run_spmd(world, body, exchange=pkg.LocalExchange)[0]


def _eig(pkg, world=3, backend="numpy"):
    n, p = 48, 3
    a = _test_matrix(n, p)

    def body(rank, ex):
        A = pkg.ShardedMatrix.from_global(a, 8, world=world, rank=rank)
        spec = pkg.SweepSpec(n, p, block_rows=8, tol=1e-9, max_sweeps=60,
                             backend=backend)
        theta, X, _ = pkg.SubspaceEigensolver(A, spec, ex).run()
        return np.concatenate([theta[None, :], X])
    return run_spmd(world, body, exchange=pkg.LocalExchange)[0]


PARITY = {"summa": _summa, "tsqr": _tsqr, "blocked_qr": _blocked_qr,
          "eigensolve": _eig}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_numpy_backend_bit_equal_to_jax(case):
    """The host f64 data plane is the JAX package's: the same numbers,
    bit for bit, at world > 1."""
    port, jax_ = _both(PARITY[case])
    assert np.array_equal(port, jax_)


@pytest.mark.parametrize("case", sorted(PARITY))
def test_device_backend_within_1e12_of_jax(case):
    """The port's device backend (torch f64, on the CPU here) against
    JAX's numpy results: within 1e-12 (relative to the largest entry)
    for the products and factors; the eigensolve's Ritz values within
    1e-12 and its vectors within 1e-9, the cross-world bound the
    eigensolver's own parity test uses."""
    port = PARITY[case](dlinalg, backend="xla")
    ref = PARITY[case](jdl)
    scale = max(1.0, float(np.abs(ref).max()))
    if case == "eigensolve":
        assert np.max(np.abs(port[0] - ref[0])) <= 1e-12 * scale
        assert np.max(np.abs(port[1:] - ref[1:])) <= 1e-9
    else:
        assert np.max(np.abs(port - ref)) <= 1e-12 * scale


def test_device_backend_raises_off_its_device(monkeypatch):
    """Without a card and without the CPU asked for, the device backend
    raises; an unknown backend raises."""
    a = np.eye(4)
    monkeypatch.setattr(port_device, "DEFAULT_DEVICE", "cuda")
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dlinalg.gemm(a, a, backend="xla")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dlinalg.local_qr(a, backend="xla")
    with pytest.raises(ValueError, match="backend"):
        dlinalg.gemm(a, a, backend="tpu")
    with pytest.raises(ValueError, match="backend"):
        dlinalg.local_qr(a, backend="tpu")


def _interrupted_then_resumed(writer, reader, lineages, tmp_path):
    """An eigensolve interrupted at (sweep 2, panel 1) by ``writer``'s
    package, resumed by ``reader``'s from the snapshot it left. ->
    (theta, X, resumed solver, uninterrupted theta, X, solver)."""
    n, p = 48, 3
    a = _test_matrix(n, p)

    def fresh(pkg, lineage=None):
        A = pkg.ShardedMatrix.from_global(a, 8)
        spec = pkg.SweepSpec(n, p, block_rows=8, tol=1e-9, max_sweeps=60,
                             checkpoint_panels=True)
        return pkg.SubspaceEigensolver(A, spec, pkg.LocalExchange(),
                                       lineage=lineage)

    base = fresh(reader)
    t_ref, x_ref, _ = base.run()

    class _Boom(Exception):
        pass

    def bomb(s, b):
        if s == 2 and b == 1:
            raise _Boom()

    root = str(tmp_path / "ck")
    victim = fresh(writer, lineages[writer].CheckpointLineage(root))
    with pytest.raises(_Boom):
        victim.run(on_panel=bomb)
    heir = fresh(reader, lineages[reader].CheckpointLineage(root))
    assert heir.restore() is not None
    assert (heir.sweep, heir.panel) == (2, 2)
    t2, x2, converged = heir.run()
    assert converged
    return t2, x2, heir, t_ref, x_ref, base


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_eigensolve_snapshot_resumes_across_packages(direction, tmp_path):
    """An eigensolve snapshot (exact-f64 lists) that one package wrote
    resumes in the other, bit-identical to an uninterrupted run."""
    lineages = {dlinalg: fault, jdl: jfault}
    writer, reader = (jdl, dlinalg) if direction == "jax_to_port" \
        else (dlinalg, jdl)
    t2, x2, heir, t_ref, x_ref, base = _interrupted_then_resumed(
        writer, reader, lineages, tmp_path)
    assert np.array_equal(t2, t_ref)
    assert np.array_equal(x2, x_ref)
    assert heir.residual_history == base.residual_history
    ref = np.linalg.eigvalsh(_test_matrix(48, 3))[::-1][:3]
    assert np.allclose(t2, ref, rtol=1e-8)


# ------------------------------------------------- chaos (the launcher)
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


def _assert_answer_is_right(log, what):
    m = re.search(r"DONE (\d+) ([\d.eE+-]+)", log)
    assert m, f"{what}: no DONE marker:\n{log}"
    assert float(m.group(2)) < 1e-6, f"{what}: residual {m.group(2)}"
    m = re.search(r"THETA_ERR ([\d.eE+-]+)", log)
    assert m, f"{what}: no THETA_ERR marker:\n{log}"
    assert float(m.group(1)) < 1e-6, f"{what}: theta err {m.group(1)}"


@pytest.mark.slow
def test_dlinalg_elastic_sigkill_resumes_from_committed_panel(tmp_path):
    """SIGKILL one worker of a 3-worker elastic eigensolve mid-sweep under
    ``--np 2:3 --max_restarts 0``: a scale event, a world-2 incarnation
    that resumes from the last committed panel, and the right answer."""
    log_dir = str(tmp_path / "logs")
    env = _clean_env({
        "PADDLE_TPU_CKPT_DIR": str(tmp_path / "ck"),
        "PADDLE_TPU_FT_STORE_PORT": str(_free_port()),
        "PADDLE_TPU_DLA_N": "96", "PADDLE_TPU_DLA_P": "4",
        "PADDLE_TPU_DLA_BLOCK": "16",
        "PADDLE_TPU_DLA_SLEEP_S": "0.05",
        "PADDLE_TPU_DLA_KILL": "2:9",
    })
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--np", "2:3", "--master", f"127.0.0.1:{_free_port()}",
         "--elastic_port", str(_free_port()), "--max_restarts", "0",
         "--terminate_grace", "5", "--log_dir", log_dir, WORKER],
        env=env, capture_output=True, text=True, timeout=600, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "scale event" in r.stderr
    assert "relaunching at world_size=2" in r.stderr
    k = _read_worker_logs(log_dir, 2)
    assert "WORLD 3" in k and "SELF_SIGKILL" in k
    assert re.search(r"PANEL 1 \d", k)
    for rank in (0, 1):
        log = _read_worker_logs(log_dir, rank)
        assert "WORLD 3" in log and "WORLD 2" in log
        round1 = log.split("WORLD 2", 1)[1]
        m = re.search(r"RESUMED step=(\d+) sweep=(\d+) panel=(\d+)",
                      round1)
        assert m, f"rank {rank} resumed FRESH:\n{log}"
        step, sweep, panel = (int(x) for x in m.groups())
        assert step >= 1 and (sweep, panel) >= (1, 0)
        pm = re.search(r"PANEL (\d+) (\d+)", round1)
        assert pm and (int(pm.group(1)), int(pm.group(2))) == (sweep, panel)
        _assert_answer_is_right(round1, f"rank {rank}")


@pytest.mark.slow
def test_dlinalg_wal_failover_primary_death_mid_run(tmp_path):
    """The dlinalg control plane on a FailoverStore: the primary dies
    mid-run, then a worker SIGKILLs itself; the relaunched incarnation
    rotates to the standby, restores and finishes with the right
    answer."""
    p1, p2 = _free_port(), _free_port()
    prim = dist.TCPStore("127.0.0.1", p1, is_master=True, timeout=15)
    stand = dist.TCPStore("127.0.0.1", p2, is_master=True, timeout=15)
    shipper = dist.LogShipper(f"127.0.0.1:{p1}", f"127.0.0.1:{p2}",
                              poll_s=0.05)
    shipper.start()
    log_dir = str(tmp_path / "logs")
    env = _clean_env({
        "PADDLE_TPU_CKPT_DIR": str(tmp_path / "ck"),
        "PADDLE_TPU_DLA_STORE_ENDPOINTS": f"127.0.0.1:{p1},127.0.0.1:{p2}",
        "PADDLE_TPU_DLA_N": "96", "PADDLE_TPU_DLA_P": "4",
        "PADDLE_TPU_DLA_BLOCK": "16",
        "PADDLE_TPU_DLA_SLEEP_S": "0.1",
        "PADDLE_TPU_DLA_KILL": "1:8",
    })
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--master", f"127.0.0.1:{_free_port()}",
         "--max_restarts", "3", "--terminate_grace", "5",
         "--log_dir", log_dir, WORKER],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=REPO)
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if "SWEEP" in _read_worker_logs(log_dir, 0):
                break
            if proc.poll() is not None:
                break
            time.sleep(0.1)
        else:
            pytest.fail("no sweep ever committed")
        prim.stop_server()
        out, err = proc.communicate(timeout=480)
    finally:
        if proc.poll() is None:
            proc.kill()
            out, err = proc.communicate()
        shipper.stop()
        stand.stop_server()
    assert proc.returncode == 0, out + err
    assert shipper.shipped_total > 0
    assert "SELF_SIGKILL" in _read_worker_logs(log_dir, 1)
    assert any("re-homed to standby" in _read_worker_logs(log_dir, rank)
               for rank in (0, 1))
    for rank in (0, 1):
        chunks = _read_worker_logs(log_dir, rank).split("WORLD 2")
        assert len(chunks) >= 3, f"rank {rank} never relaunched"
        assert "RESUMED step=" in chunks[-1]
        _assert_answer_is_right(chunks[-1], f"rank {rank}")
