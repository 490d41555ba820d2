"""Blocked TSQR/CAQR-style QR.

* :func:`tsqr` — communication-avoiding tall-skinny QR: each rank
  factors its stacked row panels locally, the p×p R factors are
  allgathered (rank order), and EVERY rank factors the stacked Rs
  identically — root-free, so no combine broadcast and every rank ends
  holding the same replicated R bit-for-bit.
* :func:`blocked_qr` — column-panel blocked Gram-Schmidt over TSQR
  with one reorthogonalization pass; each committed panel is a
  ``linalg_panel`` fault site, oracle-gated (panel residual +
  orthonormality of the committed prefix) and a resumable unit
  (``start_panel``/``Q``/``R`` restart from the last committed panel,
  bit-identically — projections read only committed state).

All factors are sign-fixed (non-negative R diagonal), which makes the
full-rank factorization UNIQUE: the numpy and device backends and different
world sizes agree up to round-off instead of up to column signs.
"""
from __future__ import annotations

import numpy as np

from .. import fault
from .. import flight_recorder as _fr
from .layout import ShardedMatrix
from .matmul import _to_device, gemm
from .oracle import enact_panel_corrupt

__all__ = ["fix_signs", "local_qr", "qr_reference", "tsqr", "blocked_qr"]

_TINY = 1e-300


def fix_signs(q, r):
    """Flip factor signs so diag(R) >= 0 (unique full-rank QR)."""
    k = min(r.shape)
    d = np.sign(np.diagonal(r)[:k]).copy()
    d[d == 0] = 1.0
    q = q.copy()
    r = r.copy()
    q[:, :k] *= d[None, :]
    r[:k, :] *= d[:, None]
    return q, r


def local_qr(a, backend="numpy"):
    a = np.asarray(a, dtype=np.float64)
    if a.shape[0] == 0:
        return (np.zeros((0, 0)), np.zeros((0, a.shape[1])))
    if backend == "xla":
        # the device backend (``matmul.py``): torch's reduced QR in
        # float64 on the current device, fetched back as host f64
        import torch
        q, r = torch.linalg.qr(_to_device(a), mode="reduced")
        q, r = q.cpu().numpy(), r.cpu().numpy()
    elif backend == "numpy":
        q, r = np.linalg.qr(a, mode="reduced")
    else:
        raise ValueError(f"unknown dlinalg backend {backend!r}")
    return fix_signs(q, r)


def qr_reference(a):
    """Host numpy f64 reference (sign-fixed reduced QR)."""
    return local_qr(np.asarray(a, dtype=np.float64), backend="numpy")


def tsqr(Y: ShardedMatrix, exchange, *, backend="numpy", tag="tsqr",
         timeout=120.0):
    """Tall-skinny QR of a row-sharded Y; returns (Q sharded like Y,
    R replicated)."""
    lay, rank, world = Y.layout, Y.rank, Y.layout.world
    blocks = Y.owned
    local = (np.vstack([Y.block(b) for b in blocks]) if blocks
             else np.zeros((0, Y.n_cols)))
    q1, r1 = local_qr(local, backend)
    exchange.publish(f"{tag}/r1/{rank}", r1)
    r1s = [exchange.fetch(f"{tag}/r1/{r}", timeout=timeout)
           for r in range(world)]
    stacked = np.vstack(r1s)
    # every rank factors the identical stacked bytes with the identical
    # routine — Q2/R come out bit-identical with no broadcast
    q2, r = local_qr(stacked, backend)
    off = sum(r1s[r].shape[0] for r in range(rank))
    q2_mine = q2[off:off + r1.shape[0]]
    qloc = q1 @ q2_mine
    Q = ShardedMatrix(lay, r.shape[1], rank)
    cur = 0
    for b in blocks:
        rows = lay.block_nrows(b)
        Q.blocks[b] = np.ascontiguousarray(qloc[cur:cur + rows])
        cur += rows
    return Q, r


def blocked_qr(A: ShardedMatrix, exchange, *, panel_cols, backend="numpy",
               tag="bqr", oracle=None, on_panel=None, start_panel=0,
               Q=None, R=None, timeout=120.0):
    """Column-panel blocked QR of a row-sharded A (m >= n); returns
    (Q sharded like A, R replicated n×n upper-triangular).

    Resumable: ``on_panel(j, Q, R)`` fires after panel ``j`` commits;
    restart with the committed ``Q``/``R`` and ``start_panel=j+1`` for a
    bit-identical continuation. With an ``oracle``, every panel commit
    is gated on the panel residual ``||A_p − Q R_p||/||A_p||`` and the
    committed prefix's orthonormality.
    """
    lay, rank, world = A.layout, A.rank, A.layout.world
    n = A.n_cols
    n_panels = -(-n // panel_cols)
    if Q is None:
        Q = ShardedMatrix.zeros(lay, n, rank)
    if R is None:
        R = np.zeros((n, n))
    for j in range(start_panel, n_panels):
        c0, c1 = j * panel_cols, min(n, (j + 1) * panel_cols)
        w = c1 - c0
        ent = _fr.record_issue(
            "linalg_panel", group="dlinalg", shape=(lay.n_rows, w),
            dtype="float64", site="linalg_panel",
            extra={"workload": "blocked_qr", "tag": tag, "panel": j})
        # project the panel against the committed basis (+ one reorth
        # pass — classical block Gram-Schmidt needs it for f64-tight
        # orthogonality)
        W = {b: A.block(b)[:, c0:c1].copy() for b in A.owned}
        S = np.zeros((c0, w))
        if c0:
            for it in range(2):
                part = np.zeros((c0, w))
                for b in A.owned:
                    part += Q.block(b)[:, :c0].T @ W[b]
                Sk = exchange.reduce_sum(f"{tag}/p{j}/proj{it}", rank,
                                         world, part, timeout=timeout)
                for b in A.owned:
                    W[b] -= gemm(Q.block(b)[:, :c0], Sk, backend)
                S += Sk
        kind = fault.maybe_inject("linalg_panel")
        if kind == "panel_corrupt" and A.owned:
            b0 = A.owned[0]
            W[b0] = enact_panel_corrupt(W[b0], f"qr {tag} panel {j}", rank)
        Wm = ShardedMatrix(lay, w, rank, blocks=W)
        Qp, Rp = tsqr(Wm, exchange, backend=backend, tag=f"{tag}/p{j}",
                      timeout=timeout)
        for b in A.owned:
            Q.block(b)[:, c0:c1] = Qp.block(b)
        R[:c0, c0:c1] = S
        R[c0:c1, c0:c1] = Rp
        if oracle is not None:
            # panel residual ||A_p − Q[:, :c1] R[:c1, p]|| / ||A_p||
            num = den = 0.0
            for b in A.owned:
                d = A.block(b)[:, c0:c1] \
                    - Q.block(b)[:, :c1] @ R[:c1, c0:c1]
                num += float(np.sum(d * d))
                den += float(np.sum(A.block(b)[:, c0:c1] ** 2))
            gram = np.zeros((c1, c1))
            for b in A.owned:
                gram += Q.block(b)[:, :c1].T @ Q.block(b)[:, :c1]
            vals = exchange.reduce_sum(
                f"{tag}/p{j}/gate", rank, world,
                np.concatenate([[num, den], gram.ravel()]),
                timeout=timeout)
            oracle.check(f"qr_panel_residual p{j}",
                         np.sqrt(vals[0]) / max(np.sqrt(vals[1]), _TINY),
                         oracle.tol_orth, "||A_p - Q R_p|| / ||A_p||")
            oracle.check_orthonormal(vals[2:].reshape(c1, c1),
                                     what=f"qr_orthonormality p{j}")
        if ent is not None:
            _fr.record_complete(ent)
        if on_panel is not None:
            on_panel(j, Q, R)
    return Q, R
