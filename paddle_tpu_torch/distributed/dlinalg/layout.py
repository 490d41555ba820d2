"""Block-cyclic row layout + host-blocked sharded matrix.

The dlinalg subsystem shards a matrix by ROW PANELS dealt cyclically
over the world (block ``b`` lives on rank ``b % world``) — the 1-D
block-cyclic distribution of arxiv 2112.09017's DMRG sweeps. The layout
is a pure function of ``(n_rows, block_rows, world)``, so after an
elastic world change every survivor recomputes ownership locally and
the resharding story reduces to "load the blocks you now own from the
snapshot, whoever saved them" (checkpoint metadata merges every rank's
entries, so cross-world restore needs no shuffle step).

Blocks are HOST numpy arrays: the robustness contract (checkpoint every
committed panel, bit-identical resume) wants f64 bytes the accelerator
config can't silently downcast; kernels move panels to the card (as
float64 tensors) per GEMM when the ``xla`` (device) backend is
selected.
"""
from __future__ import annotations

import numpy as np

__all__ = ["BlockCyclicLayout", "ShardedMatrix"]


class BlockCyclicLayout:
    """Row-panel block-cyclic layout: block ``b`` covers rows
    ``[b*block_rows, min(n_rows, (b+1)*block_rows))`` and is owned by
    rank ``b % world``. The block COUNT is world-independent — only
    ownership changes when the world resizes, which is what makes
    elastic resharding a metadata-only operation."""

    def __init__(self, n_rows, block_rows, world=1):
        if n_rows <= 0 or block_rows <= 0:
            raise ValueError(f"bad layout: n_rows={n_rows} "
                             f"block_rows={block_rows}")
        if world < 1:
            raise ValueError(f"bad layout: world={world}")
        self.n_rows = int(n_rows)
        self.block_rows = int(block_rows)
        self.world = int(world)
        self.n_blocks = -(-self.n_rows // self.block_rows)

    def owner(self, b) -> int:
        return b % self.world

    def blocks_of(self, rank):
        """Blocks owned by ``rank``, in global block order."""
        return tuple(b for b in range(self.n_blocks)
                     if b % self.world == rank)

    def row_range(self, b):
        lo = b * self.block_rows
        return lo, min(self.n_rows, lo + self.block_rows)

    def block_nrows(self, b) -> int:
        lo, hi = self.row_range(b)
        return hi - lo

    def reshard(self, new_world) -> "BlockCyclicLayout":
        return BlockCyclicLayout(self.n_rows, self.block_rows, new_world)

    def reshard_moves(self, new):
        """Ownership deltas to ``new`` (same rows/blocking, different
        world): ``[(block, old_owner, new_owner), ...]`` for blocks that
        change hands."""
        if (new.n_rows, new.block_rows) != (self.n_rows, self.block_rows):
            raise ValueError("reshard_moves needs an identical blocking")
        return [(b, self.owner(b), new.owner(b))
                for b in range(self.n_blocks)
                if self.owner(b) != new.owner(b)]

    def __eq__(self, other):
        return (isinstance(other, BlockCyclicLayout)
                and (self.n_rows, self.block_rows, self.world)
                == (other.n_rows, other.block_rows, other.world))

    def __repr__(self):
        return (f"BlockCyclicLayout(n_rows={self.n_rows}, "
                f"block_rows={self.block_rows}, world={self.world})")


class ShardedMatrix:
    """A row-panel-sharded matrix: this rank holds the blocks the layout
    assigns it, as f64 host arrays keyed by global block index."""

    def __init__(self, layout, n_cols, rank=0, blocks=None,
                 dtype=np.float64):
        self.layout = layout
        self.n_cols = int(n_cols)
        self.rank = int(rank)
        self.dtype = np.dtype(dtype)
        self.blocks = {}
        owned = set(layout.blocks_of(self.rank))
        if blocks:
            for b, arr in blocks.items():
                if b not in owned:
                    raise ValueError(f"block {b} is not owned by rank "
                                     f"{self.rank} under {layout}")
                self.set_block(b, arr)

    # -- construction --
    @classmethod
    def zeros(cls, layout, n_cols, rank=0, dtype=np.float64):
        m = cls(layout, n_cols, rank, dtype=dtype)
        for b in layout.blocks_of(rank):
            m.blocks[b] = np.zeros((layout.block_nrows(b), n_cols),
                                   dtype=dtype)
        return m

    @classmethod
    def from_global(cls, arr, block_rows, world=1, rank=0):
        """Shard a full host array; keeps only this rank's blocks."""
        arr = np.asarray(arr, dtype=np.float64)
        lay = BlockCyclicLayout(arr.shape[0], block_rows, world)
        m = cls(lay, arr.shape[1], rank)
        for b in lay.blocks_of(rank):
            lo, hi = lay.row_range(b)
            m.blocks[b] = arr[lo:hi].copy()
        return m

    # -- access --
    @property
    def n_rows(self):
        return self.layout.n_rows

    @property
    def shape(self):
        return (self.layout.n_rows, self.n_cols)

    @property
    def owned(self):
        return self.layout.blocks_of(self.rank)

    def block(self, b):
        return self.blocks[b]

    def set_block(self, b, arr):
        if self.layout.owner(b) != self.rank:
            raise ValueError(f"block {b} is not owned by rank "
                             f"{self.rank} under {self.layout}")
        arr = np.asarray(arr, dtype=self.dtype)
        want = (self.layout.block_nrows(b), self.n_cols)
        if arr.shape != want:
            raise ValueError(f"block {b}: shape {arr.shape} != {want}")
        self.blocks[b] = arr.copy()

    # -- gather --
    def to_global(self):
        """Assemble the full array from LOCAL blocks (world 1, or after
        a gather)."""
        out = np.zeros(self.shape, dtype=self.dtype)
        for b in range(self.layout.n_blocks):
            lo, hi = self.layout.row_range(b)
            out[lo:hi] = self.blocks[b]
        return out

    def gather_global(self, exchange, tag, timeout=120.0):
        """Every owner publishes its blocks; every rank assembles the
        full array (used for the replicated subspace basis and tests)."""
        for b in self.owned:
            exchange.publish(f"{tag}/b{b}", self.blocks[b])
        out = np.zeros(self.shape, dtype=self.dtype)
        for b in range(self.layout.n_blocks):
            lo, hi = self.layout.row_range(b)
            out[lo:hi] = exchange.fetch(f"{tag}/b{b}", timeout=timeout)
        return out
