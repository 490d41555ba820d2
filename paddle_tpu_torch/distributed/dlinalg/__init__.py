"""Fault-tolerant distributed linear algebra: the port's copy of
``paddle_tpu/distributed/dlinalg`` (the host numpy f64 data plane, the
exchange's keys and the snapshot format are the JAX package's; the
``xla`` backend is torch in float64 on the card, ``matmul.py``).

The platform's second large-scale workload after NN training/serving:
block-cyclic sharded matrices, SUMMA matmul, blocked TSQR/CAQR QR and
a DMRG-flavored subspace-iteration sweep solver (arxiv 2112.09017) —
every kernel with a host-numpy f64 parity reference, every committed
panel a resumable checkpointed unit, and every step gated by an exact
numerical-correctness oracle so a chaos run proves the ANSWER, not
just completion.
"""
from .exchange import (  # noqa: F401
    ExchangeTimeout, LocalExchange, StoreExchange,
)
from .layout import BlockCyclicLayout, ShardedMatrix  # noqa: F401
from .matmul import gemm, matmul_reference, summa_matmul  # noqa: F401
from .oracle import (  # noqa: F401
    OracleViolation, ResidualOracle, enact_panel_corrupt,
)
from .qr import (  # noqa: F401
    blocked_qr, fix_signs, local_qr, qr_reference, tsqr,
)
from .sweep import SubspaceEigensolver, SweepSpec  # noqa: F401

__all__ = [
    "BlockCyclicLayout", "ShardedMatrix",
    "ExchangeTimeout", "LocalExchange", "StoreExchange",
    "gemm", "summa_matmul", "matmul_reference",
    "fix_signs", "local_qr", "qr_reference", "tsqr", "blocked_qr",
    "OracleViolation", "ResidualOracle", "enact_panel_corrupt",
    "SweepSpec", "SubspaceEigensolver",
]
