"""Numerical-correctness oracle.

Unlike SGD, linear algebra has EXACT correctness conditions — residual
norms — so a chaos run can prove "it completed AND the answer is
right". Every gated step routes through :class:`ResidualOracle`:
a violated gate raises :class:`OracleViolation` (a NAMED loud failure,
mapped to ``fault.EXIT_ORACLE`` by the workers) instead of letting
silent corruption ride into the result.

Gate shapes:

* ``verify_panel`` — probabilistic mat-vec identity check (Freivalds
  style) that a just-computed panel ``Y_b`` really equals ``A_b @ Q``:
  ``A_b (Q x) == Y_b x`` for random ``x``. O(rows·n) per probe, no
  second GEMM — cheap enough to gate EVERY committed panel, and a
  large corruption is detected with probability ~1 per probe.
* ``freivalds_matmul`` — the same identity for a full sharded product
  ``C = A @ B`` (bench/parity surface).
* ``check_orthonormal`` — ``||QᵀQ − I||_F`` on the replicated basis.
* ``check`` — generic scalar gate (QR residual ``||Y − QR||/||Y||``,
  per-sweep eigen-residual ceiling); every observation is appended to
  ``history`` so the solver checkpoints the residual trace.
"""
from __future__ import annotations

import sys

import numpy as np

__all__ = ["OracleViolation", "ResidualOracle", "enact_panel_corrupt"]

_TINY = 1e-300


class OracleViolation(RuntimeError):
    """A residual/orthogonality gate failed: the numbers are WRONG, not
    late. Never auto-resumed (``fault.EXIT_ORACLE``)."""

    def __init__(self, what, value, tol, detail=""):
        self.what = what
        self.value = float(value)
        self.tol = float(tol)
        self.detail = detail
        msg = (f"oracle violation [{what}]: {self.value:.3e} exceeds "
               f"tol {self.tol:.1e}")
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


def enact_panel_corrupt(arr, what, rank=0):
    """Enact the cooperative ``panel_corrupt`` fault: return a copy of
    ``arr`` with one entry blown up (models silent memory/transport
    corruption after a fault — the oracle must turn this into a loud
    OracleViolation)."""
    print(f"[fault] rank {rank}: enacting panel_corrupt on {what}",
          file=sys.stderr, flush=True)
    out = np.array(arr, copy=True)
    if out.size:
        scale = max(1.0, float(np.abs(out).max()))
        out.flat[0] += scale * 1e3
    return out


class ResidualOracle:
    """Per-run gate state: tolerances, deterministic probe RNG and the
    residual history the solver checkpoints."""

    def __init__(self, tol=1e-6, tol_orth=1e-8, tol_panel=None,
                 residual_ceiling=1e6, vectors=2, seed=0):
        self.tol = float(tol)                    # convergence target
        self.tol_orth = float(tol_orth)          # basis/QR consistency
        self.tol_panel = float(tol_panel if tol_panel is not None
                               else tol_orth)    # per-panel identity
        self.residual_ceiling = float(residual_ceiling)
        self.vectors = int(vectors)
        self.seed = int(seed)
        self.history = []  # [(what, value), ...] in observation order

    # -- generic scalar gate --
    def check(self, what, value, tol, detail=""):
        value = float(value)
        self.history.append((what, value))
        if not np.isfinite(value) or value > tol:
            raise OracleViolation(what, value, tol, detail)
        return value

    # -- panel product gate --
    def verify_panel(self, a_block, q, y_block, what, key=()):
        """Gate ``y_block == a_block @ q`` via the mat-vec identity with
        deterministic probe vectors (seeded off ``(seed, *key)`` so a
        resumed incarnation probes identically)."""
        rng = np.random.default_rng([self.seed & 0x7FFFFFFF,
                                     *[int(k) & 0x7FFFFFFF for k in key]])
        worst = 0.0
        for _ in range(self.vectors):
            x = rng.standard_normal(q.shape[1])
            lhs = a_block @ (q @ x)
            rhs = y_block @ x
            rel = float(np.linalg.norm(lhs - rhs)
                        / max(np.linalg.norm(lhs), _TINY))
            worst = max(worst, rel)
        return self.check(what, worst, self.tol_panel,
                          "panel product identity A_b(Qx) == Y_b x")

    # -- sharded matmul gate --
    def freivalds_matmul(self, A, B, C, exchange, tag, timeout=120.0):
        """Gate ``C == A @ B`` for row-sharded A/B/C (shared rank/world)
        via ``A (B x) == C x`` with deterministic probes; the scalar
        residual is reduced in rank order so every rank sees the same
        verdict."""
        rank, world = A.rank, A.layout.world
        rng = np.random.default_rng([self.seed & 0x7FFFFFFF, 0x5CA1AB1E])
        worst = 0.0
        for t in range(self.vectors):
            x = rng.standard_normal(B.n_cols)
            bx_part = np.zeros(B.n_rows)
            for b in B.owned:
                lo, hi = B.layout.row_range(b)
                bx_part[lo:hi] = B.block(b) @ x
            bx = exchange.reduce_sum(f"{tag}/fv{t}/bx", rank, world,
                                     bx_part, timeout=timeout)
            num = den = 0.0
            for b in A.owned:
                lhs = A.block(b) @ bx
                rhs = C.block(b) @ x
                num += float(np.sum((lhs - rhs) ** 2))
                den += float(np.sum(lhs ** 2))
            vals = exchange.reduce_sum(f"{tag}/fv{t}/res", rank, world,
                                       np.array([num, den]),
                                       timeout=timeout)
            worst = max(worst, float(np.sqrt(vals[0])
                                     / max(np.sqrt(vals[1]), _TINY)))
        return self.check("matmul_freivalds", worst, self.tol_panel,
                          "Freivalds identity A(Bx) == Cx")

    # -- basis gate --
    def check_orthonormal(self, gram, what="orthonormality"):
        k = gram.shape[0]
        defect = float(np.linalg.norm(gram - np.eye(k)))
        return self.check(what, defect, self.tol_orth,
                          "||QtQ - I||_F on the committed basis")
