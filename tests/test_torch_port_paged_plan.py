"""The paged decode kernel's launch sizing, on the host.

``paged_attention.launch_plan`` picks the split count and the split
scratch from host integers alone (``context_lens`` stays on the device);
the kernel owns the rest of its geometry. Here a plain Python mirror of
that geometry and of what the kernel's blocks then do on the device —
each block reads its row's context, cuts the row's key tiles into
contiguous ranges over the splits it can use, and loads the page ids of
its range — is checked over random contexts and shapes: every key of a
row's context falls in exactly one split, none past it in any, only table
entries the context covers are read, and the grid and scratch fit the
plan.
"""
import importlib
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

pa = importlib.import_module("paddle_tpu_torch.ops.kernels.paged_attention")

SRC = os.path.join(os.path.dirname(pa.__file__), "csrc", "paged_attention.cu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _heads(G):
    """Query heads a block (the kernel's heads_per_block)."""
    gb = 1
    while gb < G and gb < pa.MAX_HEADS:
        gb *= 2
    return gb


def _geometry(B, H, KVH, max_pages, page, n_split):
    """(heads a block, head groups a KV head, grid, page ids a split can
    span) as the kernel's C entry computes them."""
    gb = _heads(H // KVH)
    n_hg = -(-(H // KVH) // gb)
    max_tiles = -(-max_pages * page // pa.KEY_TILE)
    tiles = -(-max_tiles // n_split)
    split_pages = min(max_pages, -(-tiles * pa.KEY_TILE // page) + 1)
    return gb, n_hg, (B, KVH * n_hg, n_split), split_pages


def _splits(ctx, plan, max_pages, page):
    """(split, first key, end key, first page, pages) of every block of a
    row that finds work, as the kernel maps it."""
    kt = pa.KEY_TILE
    c = min(max(ctx, 0), max_pages * page)
    n_tiles = -(-c // kt)
    ns = max(1, min(plan["n_split"], n_tiles))
    out = []
    for split in range(plan["n_split"]):
        if split >= ns:
            continue
        t_lo, t_hi = split * n_tiles // ns, (split + 1) * n_tiles // ns
        k_lo, k_hi = t_lo * kt, min(t_hi * kt, c)
        p_first = k_lo // page
        n_pg = (k_hi - 1) // page - p_first + 1 if t_hi > t_lo else 0
        out.append((split, k_lo, k_hi, p_first, n_pg))
    return out


def _contexts(rng, B, max_pages, page):
    """0, 1, page and tile edges, the full table, past the table, and
    random contexts, cycled over B rows."""
    full = max_pages * page
    pool = [0, 1, page - 1, page, page + 1, 15, 16, 17, full - 1, full,
            full + 5] + rng.randint(0, full + 1, size=8).tolist()
    rng.shuffle(pool)
    return [pool[i % len(pool)] for i in range(B)]


@pytest.mark.parametrize("seed", range(12))
def test_plan_covers_every_key_once(seed):
    rng = np.random.RandomState(seed)
    B = [1, 2, 16, 33, 64, 5][seed % 6]
    G = [1, 3, 4, 8, 16, 2][seed % 6]
    KVH = [16, 2, 4, 1][seed % 4]
    H, D = KVH * G, [64, 128][seed % 2]
    max_pages = [64, 1, 4, 100][seed % 4]
    page = [16, 8, 32, 5][(seed // 4) % 4]
    sms = [132, 114][seed % 2]
    plan = pa.launch_plan(B, H, KVH, D, max_pages, page, sms)
    gb, n_hg, grid, split_pages = _geometry(B, H, KVH, max_pages, page,
                                            plan["n_split"])
    assert grid[0] * grid[1] * grid[2] == B * KVH * n_hg * plan["n_split"]
    assert gb in (1, 2, 4, 8)
    assert gb * n_hg >= G > gb * (n_hg - 1)
    assert 1 <= plan["n_split"] <= pa.MAX_SPLIT
    ctxs = _contexts(rng, B, max_pages, page)
    part_hi = tick_hi = -1
    for b, ctx in enumerate(ctxs):
        # a -1-padded table: only the entries the context covers are real
        n_real = -(-min(ctx, max_pages * page) // page)
        table = np.full(max_pages, -1)
        table[:n_real] = rng.randint(0, 1000, size=n_real)
        keys = np.zeros(max_pages * page + 8, np.int64)
        blocks = _splits(ctx, plan, max_pages, page)
        for split, k_lo, k_hi, p_first, n_pg in blocks:
            keys[k_lo:k_hi] += 1
            assert n_pg <= split_pages
            read = table[p_first:p_first + n_pg]
            assert len(read) == n_pg and (read >= 0).all()
            for h in range(H):
                part_hi = max(part_hi, ((b * H + h) * plan["n_split"]
                                        + split + 1) * (D + 2))
            tick_hi = max(tick_hi, (b + 1) * KVH * n_hg)
        c = min(ctx, max_pages * page)
        assert (keys[:c] == 1).all() and (keys[c:] == 0).all()
        n_tiles = -(-c // pa.KEY_TILE)
        if n_tiles >= plan["n_split"]:      # no split of the row is idle
            assert len(blocks) == plan["n_split"]
            assert all(hi > lo for _, lo, hi, _, _ in blocks)
        assert len(blocks) == max(1, min(plan["n_split"], n_tiles))
    if plan["n_split"] > 1:
        assert part_hi <= plan["partials"] and tick_hi <= plan["tickets"]
    else:
        assert plan["partials"] == plan["tickets"] == 0


def test_plan_sizes_from_host_integers():
    """The serving engine's decode step (16 rows of gpt_1p3b, KVH 16,
    max_pages 64) takes 3 splits a (row, KV head) on 132 SMs; one row of
    1024 keys 16 splits of four tiles; G 16 two head groups of 8, each
    with its ticket; a table of one page one split and no scratch."""
    p = pa.launch_plan(16, 16, 16, 128, 64, 16, 132)
    assert p == {"n_split": 3, "partials": 16 * 16 * 3 * 130,
                 "tickets": 256}
    assert _geometry(16, 16, 16, 64, 16, 3) == (1, 1, (16, 16, 3), 23)
    one = pa.launch_plan(1, 16, 16, 128, 64, 16, 132)
    assert one["n_split"] == 16
    assert _geometry(1, 16, 16, 64, 16, 16)[3] == 5
    g16 = pa.launch_plan(2, 32, 2, 64, 64, 16, 132)
    assert g16["tickets"] == 2 * 2 * 2
    assert _geometry(2, 32, 2, 64, 16, g16["n_split"])[:2] == (8, 2)
    assert _heads(12 // 4) == 4
    assert pa.launch_plan(64, 16, 16, 128, 1, 16, 132) == {
        "n_split": 1, "partials": 0, "tickets": 0}
    with pytest.raises(ValueError, match="not divisible"):
        pa.launch_plan(1, 12, 8, 64, 4, 16, 132)


def test_plan_and_scratch_stay_fixed_per_shape(monkeypatch):
    """A fixed (B, H, KVH, D, max_pages, page) gives the same plan on
    every call, so the cached scratch keeps its pointers (what a captured
    CUDA graph needs); a smaller plan reuses it, a bigger one grows it."""
    monkeypatch.setattr(pa, "_scratch", {})
    dev = torch.device("cpu")
    plans = [pa.launch_plan(16, 16, 16, 128, 64, 16, 132) for _ in range(3)]
    assert plans[0] == plans[1] == plans[2]
    ptrs = [pa._split_scratch(dev, plans[0]["partials"],
                              plans[0]["tickets"]) for _ in range(3)]
    assert ptrs[0] == ptrs[1] == ptrs[2]
    assert pa._scratch[dev][1].eq(0).all()
    small = pa.launch_plan(4, 16, 16, 128, 64, 16, 132)
    assert small["partials"] <= plans[0]["partials"]
    assert pa._split_scratch(dev, small["partials"],
                             small["tickets"]) == ptrs[0]
    big = pa.launch_plan(64, 64, 8, 128, 64, 16, 132)
    assert big["tickets"] > plans[0]["tickets"]
    grown = pa._split_scratch(dev, big["partials"], big["tickets"])
    assert grown[0] != ptrs[0][0] and grown[1] != ptrs[0][1]
    assert pa._scratch[dev][0].numel() == big["partials"]


def test_plan_constants_match_the_kernel():
    """The plan's constants are csrc/paged_attention.cu's: keys a ring
    stage, query heads a block, the largest split count; and its head
    groups are the kernel's ceil(G / heads a block)."""
    src = open(SRC).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("KT") == pa.KEY_TILE
    assert const("kMaxHeads") == pa.MAX_HEADS
    assert const("kMaxSplit") == pa.MAX_SPLIT
    for G in range(1, 20):
        assert _heads(G) == min(8, 1 << (G - 1).bit_length())
        assert -(-G // _heads(G)) == -(-G // pa.MAX_HEADS)


def test_launch_kernel_takes_only_cuda_and_a_split_count_in_range():
    """The kernel path raises for a CPU tensor (the wrapper routes those
    to the plain version) before it builds anything."""
    q = torch.zeros(2, 4, 64)
    kv = torch.zeros(8, 16, 4, 64)
    bt = torch.zeros(2, 4, dtype=torch.int32)
    ctx = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="runs on cuda"):
        pa.launch_kernel(q, kv, kv, bt, ctx, n_split=2)
    got = pa.paged_attention(q, kv, kv, bt, ctx)
    assert got.shape == q.shape


def test_bound_counts_only_the_keys_a_context_covers():
    """``chip_smoke.attention_work`` charges a row's last page only for
    the keys below its context, a page two rows share once, and only the
    table entries the contexts cover (a -1-padded table's tail is never
    read)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    H, KVH, D, page = 16, 4, 128, 16
    bt = np.full((3, 8), -1)
    bt[0, :3] = [5, 6, 7]       # 40 keys: 16 + 16 + 8
    bt[1, :1] = [9]             # 1 key
    bt[2, :2] = [5, 6]          # 20 keys on row 0's first pages
    kl = np.array([40, 1, 20])
    nbytes, flops, t = cs.attention_work(np.arange(3), np.ones(3), kl, bt,
                                         H, KVH, D, page, 2, row_meta=1)
    kv = 2 * (40 + 1) * KVH * D * 2
    assert t == 3
    assert nbytes == 2 * 3 * H * D * 2 + kv + 4 * (3 + 3 + 1 + 2)
    assert flops == 4 * H * D * (40 + 1 + 20)
