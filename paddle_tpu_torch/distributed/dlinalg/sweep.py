"""DMRG-flavored iterative sweep solver: resumable subspace-iteration
eigensolve (per arxiv 2112.09017).

One sweep over a symmetric row-sharded A with a replicated m×p basis Q:

  1. PANELS — for each global block ``b`` (in order), its owner computes
     ``Y_b = A_b @ Q``. Every panel is a ``linalg_panel`` fault site,
     flight-recorded, oracle-gated (mat-vec identity) and — with
     ``checkpoint_panels`` — a COMMITTED resumable unit: the full solver
     state lands through ``CheckpointLineage`` after each panel.
  2. RAYLEIGH–RITZ — ``T = QᵀY`` (rank-ordered reduction), host
     ``eigh(T)`` (p×p, replicated deterministically), Ritz values θ and
     per-column eigen-residuals ``||Y S − Q S θ||`` reduced and gated.
  3. BASIS — distributed TSQR of Y gives the next orthonormal Q
     (QR-residual + orthonormality gates), allgathered back to
     replicated form. ``linalg_sweep`` fault site + sweep checkpoint.

Resume contract: state = {sweep, panel, seed, residual history, θ, Q,
partial Y blocks} — everything is stored as exact-f64 py values, each
rank saving the blocks IT owns; checkpoint metadata merges across
ranks, so after an elastic world change a rank restores whichever
blocks the new block-cyclic layout assigns it, regardless of who saved
them, and continues from the last committed panel. A SAME-world resume
is BIT-IDENTICAL (deterministic rank-ordered reductions + restored RNG
spec + exact-f64 state); after a world CHANGE the continuation agrees
to f64 round-off — the layout and the answer are world-independent,
but TSQR stacks rows per rank, so summation association is not.

SIGTERM drains through ``fault.preemption_scope``: the solver polls at
panel boundaries (and the exchange's ``poll`` hook while blocked on a
dead peer's panel), saves any committed-but-unsaved state and exits 75
— the launcher resumes without consuming restart budget.
"""
from __future__ import annotations

import os
import time

import numpy as np

from .. import fault
from .. import flight_recorder as _fr
from .layout import ShardedMatrix
from .matmul import gemm
from .oracle import ResidualOracle, enact_panel_corrupt
from . import qr as _qr

__all__ = ["SweepSpec", "SubspaceEigensolver"]

_TINY = 1e-300


class SweepSpec:
    """Solver shape + robustness knobs."""

    def __init__(self, n, p, *, block_rows, seed=0, tol=1e-6,
                 tol_orth=1e-8, residual_ceiling=1e6, max_sweeps=60,
                 backend="numpy", oracle_vectors=2,
                 checkpoint_panels=False, panel_sleep_s=0.0):
        self.n = int(n)
        self.p = int(p)
        self.block_rows = int(block_rows)
        self.seed = int(seed)
        self.tol = float(tol)
        self.tol_orth = float(tol_orth)
        self.residual_ceiling = float(residual_ceiling)
        self.max_sweeps = int(max_sweeps)
        self.backend = backend
        self.oracle_vectors = int(oracle_vectors)
        self.checkpoint_panels = bool(checkpoint_panels)
        self.panel_sleep_s = float(panel_sleep_s)


def _fix_eigvec_signs(S):
    # eigh's column signs are arbitrary; pin them (largest-magnitude
    # entry positive) so the rotated basis is deterministic across
    # backends and incarnations
    S = S.copy()
    for j in range(S.shape[1]):
        i = int(np.argmax(np.abs(S[:, j])))
        if S[i, j] < 0:
            S[:, j] = -S[:, j]
    return S


class SubspaceEigensolver:
    """Resumable subspace-iteration eigensolve of a symmetric sharded A
    for its ``p`` dominant eigenpairs."""

    def __init__(self, A: ShardedMatrix, spec: SweepSpec, exchange, *,
                 lineage=None, job="eig"):
        if A.n_cols != A.layout.n_rows:
            raise ValueError("subspace iteration needs a square A")
        self.A = A
        self.spec = spec
        self.exchange = exchange
        self.lineage = lineage
        self.job = job
        self.lay = A.layout
        self.rank = A.rank
        self.world = A.layout.world
        self.incarnation = int(os.environ.get("PADDLE_TPU_RESTART_NUM",
                                              "0"))
        self.oracle = ResidualOracle(
            tol=spec.tol, tol_orth=spec.tol_orth,
            residual_ceiling=spec.residual_ceiling,
            vectors=spec.oracle_vectors, seed=spec.seed)
        # solver state (everything a resume needs)
        self.sweep = 0
        self.panel = 0          # committed panels of the CURRENT sweep
        self.theta = None       # latest Ritz values (descending)
        self.X = None           # latest Ritz vectors (replicated m×p)
        self.Q = None           # current orthonormal basis (replicated)
        self.converged = False
        self._Y = {}            # this sweep's committed panel blocks
        self._saved_step = -1
        if getattr(exchange, "poll", None) is None:
            exchange.poll = self._poll_preempt

    # ---- state ----
    def _q(self):
        if self.Q is None:
            rng = np.random.default_rng(self.spec.seed)
            q, _ = _qr.local_qr(
                rng.standard_normal((self.lay.n_rows, self.spec.p)))
            self.Q = q
        return self.Q

    def _step(self, sweep, panel):
        # monotonic global step: one slot per committed panel plus the
        # sweep-end commit (panel == 0 of the NEXT sweep)
        return sweep * (self.lay.n_blocks + 2) + panel

    def state_dict(self):
        # exact-f64 py values on purpose: tensor entries would be cast
        # by the lineage (JAX's inherit its x64 config) — a silent f32
        # downcast would break both the 1e-6 oracle and the
        # bit-identical-resume contract; the lists also make a snapshot
        # either package wrote resume in the other
        sd = {"sweep": int(self.sweep), "panel": int(self.panel),
              "seed": int(self.spec.seed), "world": int(self.world),
              "resid_history": [list(h) for h in self.oracle.history],
              "theta": None if self.theta is None else self.theta.tolist(),
              "Q": self._q().tolist()}
        if self.spec.checkpoint_panels:
            sd["Y"] = {}
            for b in self.lay.blocks_of(self.rank):
                arr = self._Y.get(b)
                if arr is None:
                    arr = np.zeros((self.lay.block_nrows(b), self.spec.p))
                sd["Y"][f"b{b}"] = arr.tolist()
        return sd

    def restore(self):
        """Load the newest verified snapshot (resharding block ownership
        to the CURRENT world); returns the restored lineage step or None
        for a fresh start."""
        if self.lineage is None:
            return None
        target = {"sweep": 0, "panel": 0, "seed": 0, "world": 0,
                  "resid_history": [], "theta": None, "Q": None}
        if self.spec.checkpoint_panels:
            target["Y"] = {f"b{b}": None
                           for b in self.lay.blocks_of(self.rank)}
        step = self.lineage.load_latest(target)
        if step is None:
            return None
        if int(target["seed"]) != self.spec.seed:
            raise ValueError(
                f"snapshot RNG spec (seed {target['seed']}) does not "
                f"match this run (seed {self.spec.seed})")
        self.sweep = int(target["sweep"])
        self.panel = int(target["panel"])
        self.oracle.history = [tuple(h) for h in target["resid_history"]]
        self.theta = (None if target["theta"] is None
                      else np.asarray(target["theta"], dtype=np.float64))
        self.Q = np.asarray(target["Q"], dtype=np.float64)
        self._Y = {}
        if self.spec.checkpoint_panels:
            for b in self.lay.blocks_of(self.rank):
                if b < self.panel:  # committed this sweep
                    self._Y[b] = np.asarray(target["Y"][f"b{b}"],
                                            dtype=np.float64)
        self._saved_step = step
        _fr.note_resume(step, old_world=int(target["world"]),
                        new_world=self.world)
        return step

    def _save(self, step):
        if self.lineage is not None and step > self._saved_step:
            self.lineage.save(self.state_dict(), step)
            self._saved_step = step

    # ---- preemption ----
    def _poll_preempt(self):
        if fault.preempted():
            fault.exit_preempted(self._preempt_save)

    def _preempt_save(self):
        # only states at committed boundaries are saved: mid-sweep
        # states need the partial-Y keys, which exist only when panel
        # checkpointing is on
        if self.spec.checkpoint_panels or self.panel == 0:
            self._save(self._step(self.sweep, self.panel))

    def _sigterm_cb(self):
        # callback-mode SIGTERM handler: the last committed panel/sweep
        # is already durable from its in-line save, so a multi-rank
        # process exits immediately — saving here would re-enter the
        # store client from the signal frame while the interrupted op
        # may hold its mutex (and its commit barrier may be waiting on
        # a peer that is already dead). With no store in the picture
        # (world 1) squeeze in a final save of the newest committed
        # boundary.
        if self.world == 1:
            try:
                self._preempt_save()
            except Exception:
                pass

    def _interruptible_sleep(self, seconds):
        t0 = time.monotonic()
        while time.monotonic() - t0 < seconds:
            self._poll_preempt()
            time.sleep(0.02)

    # ---- the sweep loop ----
    def run(self, on_panel=None, on_sweep=None):
        """Iterate sweeps until the eigen-residual oracle passes
        ``spec.tol`` or ``max_sweeps`` is exhausted. Returns
        ``(theta, X, converged)``; raises OracleViolation on a failed
        gate."""
        spec, lay = self.spec, self.lay
        nb = lay.n_blocks
        with fault.preemption_scope(on_preempt=self._sigterm_cb):
            while self.sweep < spec.max_sweeps and not self.converged:
                s = self.sweep
                Q = self._q()
                sc = f"i{self.incarnation}/s{s}"
                # -- phase 1: panels --
                for b in range(self.panel, nb):
                    self._poll_preempt()
                    ent = _fr.record_issue(
                        "linalg_panel", group="dlinalg",
                        shape=(lay.block_nrows(b), spec.p),
                        dtype="float64", site="linalg_panel",
                        extra={"job": self.job, "sweep": s, "panel": b})
                    if lay.owner(b) == self.rank:
                        if spec.panel_sleep_s:
                            self._interruptible_sleep(spec.panel_sleep_s)
                        y = gemm(self.A.block(b), Q, spec.backend)
                        kind = fault.maybe_inject("linalg_panel")
                        if kind == "panel_corrupt":
                            y = enact_panel_corrupt(
                                y, f"sweep {s} panel {b}", self.rank)
                        self.oracle.verify_panel(
                            self.A.block(b), Q, y,
                            what=f"panel_residual s{s} b{b}", key=(s, b))
                        self._Y[b] = y
                    self.panel = b + 1
                    if spec.checkpoint_panels:
                        self._save(self._step(s, self.panel))
                    if ent is not None:
                        _fr.record_complete(ent)
                    if on_panel is not None:
                        on_panel(s, b)
                # -- phase 2: Rayleigh–Ritz in the basis Q --
                self._poll_preempt()
                part = np.zeros((spec.p, spec.p))
                for b in self._Y:
                    lo, hi = lay.row_range(b)
                    part += Q[lo:hi].T @ self._Y[b]
                T = self.exchange.reduce_sum(f"{sc}/T", self.rank,
                                             self.world, part)
                T = 0.5 * (T + T.T)
                theta, S = np.linalg.eigh(T)  # identical on every rank
                order = np.argsort(theta)[::-1]
                theta, S = theta[order], _fix_eigvec_signs(S[:, order])
                rpart = np.zeros(spec.p)
                for b in self._Y:
                    lo, hi = lay.row_range(b)
                    resid_b = self._Y[b] @ S - (Q[lo:hi] @ S) * theta
                    rpart += np.sum(resid_b ** 2, axis=0)
                rnorm = np.sqrt(self.exchange.reduce_sum(
                    f"{sc}/rnorm", self.rank, self.world, rpart))
                scale = max(float(np.abs(theta).max()), _TINY)
                maxrel = float(rnorm.max()) / scale
                # gates: the basis must be orthonormal and the residual
                # finite/sane — convergence itself is judged against tol
                self.oracle.check_orthonormal(Q.T @ Q)
                self.oracle.check("eigen_residual", maxrel,
                                  self.oracle.residual_ceiling,
                                  "||A x - theta x|| / ||A||")
                self.theta = theta
                self.X = Q @ S
                self.converged = maxrel < spec.tol
                # -- phase 3: next basis via distributed TSQR --
                Ym = ShardedMatrix(lay, spec.p, self.rank,
                                   blocks=self._Y)
                Qn, R = _qr.tsqr(Ym, self.exchange, backend=spec.backend,
                                 tag=f"{sc}/tsqr")
                num = den = 0.0
                for b in self._Y:
                    d = self._Y[b] - Qn.block(b) @ R
                    num += float(np.sum(d * d))
                    den += float(np.sum(self._Y[b] ** 2))
                vals = self.exchange.reduce_sum(
                    f"{sc}/qres", self.rank, self.world,
                    np.array([num, den]))
                self.oracle.check(
                    "qr_residual", np.sqrt(vals[0])
                    / max(np.sqrt(vals[1]), _TINY),
                    self.oracle.tol_orth, "||Y - Q R|| / ||Y||")
                self.Q = Qn.gather_global(self.exchange, f"{sc}/qn")
                # -- sweep commit --
                self._Y = {}
                self.panel = 0
                self.sweep = s + 1
                fault.maybe_inject("linalg_sweep")
                ent = _fr.record_issue(
                    "linalg_sweep", group="dlinalg",
                    shape=(lay.n_rows, spec.p), dtype="float64",
                    site="linalg_sweep",
                    extra={"job": self.job, "sweep": s,
                           "residual": maxrel})
                if ent is not None:
                    _fr.record_complete(ent)
                _fr.note_step(self.sweep)
                self._save(self._step(self.sweep, 0))
                if on_sweep is not None:
                    on_sweep(s, maxrel)
        return self.theta, self.X, self.converged

    @property
    def residual_history(self):
        return [v for what, v in self.oracle.history
                if what == "eigen_residual"]
