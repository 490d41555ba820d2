"""The ragged kernel's launch sizing, on the host.

``ragged_attention.launch_plan`` sizes the grid from host integers alone
(the engine's row metadata stays on the device). Here a plain Python
mirror of what the kernel's blocks then do on the device — the first warp's
slot -> (row, tile) prefix walk, the tile's split count, each split's key
range — is checked over random row layouts to give every valid token of
``ragged_row_index`` exactly one tile, every key of its context exactly
one split, and to fit the planned grid and scratch.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import ragged_attention as ra

BIG = 2 ** 31 - 1


def _blocks(rs, rl, kl, T, plan, max_keys):
    """The (row, first token, tokens, first position, split count) of
    every tile slot that finds work, as the kernel's first warp maps it."""
    R, bq, out = len(rs), plan["bq"], []
    for slot in range(plan["n_slots"]):
        row, acc = None, 0
        for r in range(R):
            nxt = rs[r + 1] if r + 1 < R else BIG
            n = max(0, min(rl[r], min(nxt, T) - rs[r]))
            nt = -(-n // bq)
            if slot < acc + nt:
                row, tile, length = r, slot - acc, n
                break
            acc += nt
        if row is None:
            continue
        tok0 = tile * bq
        ntok = min(bq, length - tok0)
        pos0 = kl[row] - rl[row] + tok0
        kmax = min(pos0 + ntok, max_keys)
        nsplit = max(1, -(-kmax // plan["split_keys"]))
        out.append((row, rs[row] + tok0, ntok, pos0, kmax, nsplit))
    return out


def _layout(rng, T, R):
    """Random rows back to back (decode rows of one token, segments of up
    to T / rows tokens, empty rows), unused rows at T, then pad tokens up
    to T; contexts behind random prefixes."""
    n_used = rng.randint(1, R + 1)
    lens = np.where(rng.rand(n_used) < 0.4, 1,
                    rng.randint(0, T // n_used + 1, size=n_used))
    rs = np.concatenate([[0], np.cumsum(lens)[:-1], np.full(R - n_used, T)])
    rl = np.concatenate([lens, np.zeros(R - n_used, np.int64)])
    prefix = rng.randint(0, 700, size=R) * (rng.rand(R) > 0.3)
    return rs, rl, np.where(rl > 0, rl + prefix, 0)


@pytest.mark.parametrize("seed", range(8))
def test_plan_covers_every_token_and_key_once(seed):
    rng = np.random.RandomState(seed)
    G = [1, 2, 4, 8, 16][seed % 5]
    KVH = 16 // G if G < 16 else 1
    H = KVH * G
    R, page, max_pages = 16, 16, 64
    T = [16, 64, 128, 512, 1024, 2048, 256, 32][seed]
    rs, rl, kl = _layout(rng, T, R)
    plan = ra.launch_plan(T, H, KVH, R, max_pages, page)
    max_keys = max_pages * page
    assert plan["split_keys"] % 64 == 0
    assert plan["n_split"] * plan["split_keys"] >= max_keys
    assert T * plan["n_split"] <= max(ra.SPLIT_TOKENS, T)
    _, pos, valid = ra.ragged_row_index(*(torch.tensor(a) for a in
                                          (rs, rl, kl)), T)
    hits = np.zeros(T, np.int64)
    blocks = _blocks(rs, rl, kl, T, plan, max_keys)
    assert len(blocks) <= plan["n_slots"]
    for row, t0, ntok, pos0, kmax, nsplit in blocks:
        assert 1 <= ntok <= plan["bq"] and ntok * G <= ra.TILE_ROWS
        assert nsplit <= plan["n_split"]
        for i in range(ntok):
            t = t0 + i
            hits[t] += 1
            assert int(pos[t]) == pos0 + i
            ctx = min(pos0 + i + 1, max_keys)
            keys = np.zeros(max(ctx, 0), np.int64)
            for sp in range(nsplit):
                lo = sp * plan["split_keys"]
                hi = min(lo + plan["split_keys"], kmax)
                keys[lo:min(hi, ctx)] += 1
            assert (keys == 1).all()
    np.testing.assert_array_equal(hits, valid.numpy().astype(np.int64))


def test_plan_sizes_from_host_integers():
    """Decode rounds split a row's 1024 keys 8 ways; long rounds keep
    tokens x splits within SPLIT_TOKENS; G above 64 is refused."""
    assert ra.launch_plan(16, 16, 16, 16, 64, 16) == {
        "bq": 64, "n_slots": 17, "n_split": 8, "split_keys": 128}
    assert ra.launch_plan(1024, 16, 4, 16, 64, 16) == {
        "bq": 16, "n_slots": 80, "n_split": 4, "split_keys": 256}
    assert ra.launch_plan(16384, 16, 16, 16, 64, 16)["n_split"] == 1
    with pytest.raises(ValueError, match="rows a block"):
        ra.launch_plan(8, 128, 1, 2, 4, 16)
