"""SUMMA-style sharded matmul.

``C = A @ B`` for row-panel-sharded operands sharing one mesh: round
``k`` broadcasts B's row panel ``k`` (its owner publishes, everyone
fetches), and each rank accumulates ``A_b[:, rows(k)] @ B_k`` into its
C blocks. Rounds run in GLOBAL block order with rank-order-free
accumulation per block, so the f64 result is bit-identical across
world sizes and across a resume (``start_round``/``stop_round`` carve
the round loop into resumable units; the sweep solver checkpoints the
partial C between them).

Every round is a ``linalg_panel`` fault site: wildcard ``crash``/
``hang`` fire here, and the cooperative ``panel_corrupt`` kind is
ENACTED here on the fetched panel (transport corruption) — the
Freivalds oracle on the finished product must catch it.

Backends: ``numpy`` (host f64 — the parity reference and the oracle's
substrate) and ``xla``, the JAX package's name kept for the device
backend (``SweepSpec(backend=...)`` is API): ``torch.matmul`` in
float64 on the current device (:func:`device.resolve_device`: the card
unless the caller set the CPU; without a card and without that choice
it raises). JAX computes ``xla`` in the session's dtype (float32 unless
x64 is on); the port always computes in float64, which the oracle's
1e-6 gate and the bit-identical same-world resume need.
"""
from __future__ import annotations

import numpy as np

from .. import fault
from .. import flight_recorder as _fr
from .layout import ShardedMatrix
from .oracle import enact_panel_corrupt

__all__ = ["gemm", "summa_matmul", "matmul_reference"]


def _to_device(a):
    """A host panel as a float64 tensor on the current device."""
    import torch
    from ...device import resolve_device
    return torch.from_numpy(np.ascontiguousarray(
        a, dtype=np.float64)).to(resolve_device())


def gemm(a, b, backend="numpy"):
    """One local GEMM on the selected backend; always returns host f64."""
    if backend == "numpy":
        return np.asarray(a, dtype=np.float64) @ np.asarray(
            b, dtype=np.float64)
    if backend == "xla":
        import torch
        # one fetch a panel product: the panel is then checkpointed and
        # exchanged on the host
        return torch.matmul(_to_device(a), _to_device(b)).cpu().numpy()
    raise ValueError(f"unknown dlinalg backend {backend!r}")


def matmul_reference(a, b):
    """Host numpy f64 reference."""
    return np.asarray(a, dtype=np.float64) @ np.asarray(b, dtype=np.float64)


def summa_matmul(A: ShardedMatrix, B: ShardedMatrix, exchange, *,
                 backend="numpy", tag="mm", start_round=0, stop_round=None,
                 on_round=None, C=None, timeout=120.0):
    """Sharded ``A @ B``; returns C sharded like A.

    ``start_round``/``C`` resume a partially accumulated product;
    ``stop_round`` ends early (exclusive) so callers can checkpoint
    between rounds; ``on_round(k, C)`` runs after round ``k`` commits.
    """
    if A.n_cols != B.n_rows:
        raise ValueError(f"inner dims differ: {A.shape} @ {B.shape}")
    if A.rank != B.rank or A.layout.world != B.layout.world:
        raise ValueError("A and B must share one rank/world")
    if C is None:
        C = ShardedMatrix.zeros(A.layout, B.n_cols, A.rank)
    blay = B.layout
    stop = blay.n_blocks if stop_round is None else min(stop_round,
                                                        blay.n_blocks)
    for k in range(start_round, stop):
        lo, hi = blay.row_range(k)
        ent = _fr.record_issue(
            "linalg_panel", group="dlinalg", shape=(hi - lo, B.n_cols),
            dtype="float64", site="linalg_panel",
            extra={"workload": "summa", "tag": tag, "round": k})
        if blay.owner(k) == B.rank:
            exchange.publish(f"{tag}/r{k}", B.block(k))
            bk = B.block(k)
        else:
            bk = exchange.fetch(f"{tag}/r{k}", timeout=timeout)
        kind = fault.maybe_inject("linalg_panel")
        if kind == "panel_corrupt":
            bk = enact_panel_corrupt(bk, f"summa {tag} round {k}", A.rank)
        for b in A.owned:
            C.blocks[b] += gemm(A.block(b)[:, lo:hi], bk, backend)
        if ent is not None:
            _fr.record_complete(ent)
        if on_round is not None:
            on_round(k, C)
    return C
