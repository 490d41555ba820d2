"""The port's hand-written kernels against their plain versions, on the card.

Marked ``cuda``: they skip without a CUDA device (the kernels have no CPU
mode). This file imports neither JAX nor the JAX package, so it runs on a
GPU machine without them::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_card.py
"""
import importlib
import math
import warnings

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import kernels as K

PA = importlib.import_module("paddle_tpu_torch.ops.kernels.paged_attention")


def _mixed_launch(H, KVH, D, seed, page_size, num_pages, max_pages, T):
    """A decode row, a whole-prompt prefill, a mid-page chunk
    continuation, an unused row and padded tail tokens."""
    rng = np.random.RandomState(seed)
    return dict(
        q=rng.randn(T, H, D).astype(np.float32),
        k=rng.randn(num_pages, page_size, KVH, D).astype(np.float32),
        v=rng.randn(num_pages, page_size, KVH, D).astype(np.float32),
        bt=rng.randint(1, num_pages, size=(4, max_pages)).astype(np.int32),
        rs=np.array([0, 1, 6, T], np.int32),
        rl=np.array([1, 5, 3, 0], np.int32),
        kl=np.array([7, 5, 9, 0], np.int32))


def _torch(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kvh", [16, 4])
def test_kernels_match_plain_on_card(dtype, kvh):
    """The hand-written kernels against their plain versions on the card
    (f32: atol 1e-4; bf16: atol/rtol 2e-2, a few bf16 ulps)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    tol = 1e-4 if dt == torch.float32 else 2e-2
    x = _mixed_launch(16, kvh, 128, seed=kvh, page_size=16, num_pages=32,
                      max_pages=4, T=24)
    args = [_torch(x[n]).cuda() for n in ("q", "k", "v", "rs", "rl", "kl",
                                          "bt")]
    args[0], args[1], args[2] = (a.to(dt) for a in args[:3])
    before = K.ragged_paged_attention.launches
    out = K.ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert K.ragged_paged_attention.launches == before + 1
    torch.testing.assert_close(out.float(),
                               K.ragged_paged_attention_reference(
                                   *args).float(), rtol=tol, atol=tol)
    h = torch.randn(33, 2048, device="cuda").to(dt)
    w = torch.randn(2048, device="cuda").to(dt)
    b = torch.randn(2048, device="cuda").to(dt)
    torch.testing.assert_close(K.layer_norm(h, w, b).float(),
                               K.layer_norm_reference(h, w, b).float(),
                               rtol=tol, atol=tol)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _bhsd(x):
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d)


def _bshd(x, b, h):
    return x.reshape(b, h, -1, x.shape[-1]).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,d", [
    (200, 200, 128), (70, 45, 64), (33, 97, 16), (16, 16, 128),
    # every side of the bf16 kernels' 64- and 128-row tiles, D below,
    # at and between the 64-element TMA boxes, Sq != Sk both ways
    (1, 1, 128), (63, 63, 64), (64, 64, 16), (65, 65, 128), (127, 127, 64),
    (128, 128, 128), (129, 129, 16), (1000, 1000, 128), (129, 65, 64),
    (65, 129, 128), (1, 129, 16), (257, 1, 128), (63, 1000, 96),
    (1000, 127, 128),
    # one query row, the eager generate's dense-cache step
    (1, 17, 128), (1, 129, 128), (1, 1000, 128)])
def test_flash_kernels_match_plain_on_card(dtype, causal, sq, sk, d):
    """Forward, dQ and dK/dV kernels against their plain versions, S not a
    multiple of any tile and at every side of the tiles (f32: atol 1e-4;
    bf16: rtol/atol 2e-2)."""
    _need_cuda()
    dt = getattr(torch, dtype)
    tol = 1e-4 if dt == torch.float32 else 2e-2
    g = torch.Generator(device="cuda").manual_seed(sq + sk + d)
    b, h = 2, 3
    q, do = (torch.randn(b, sq, h, d, device="cuda", generator=g).to(dt)
             for _ in range(2))
    k, v = (torch.randn(b, sk, h, d, device="cuda", generator=g).to(dt)
            for _ in range(2))
    scale = 1.0 / math.sqrt(d)
    before = K.launch_counts()
    o, lse = K.flash_fwd(q, k, v, scale, causal)
    ro, rlse = K.flash_fwd_reference(_bhsd(q), _bhsd(k), _bhsd(v), scale,
                                     causal)
    delta = K.flash_delta(_bshd(ro, b, h), do)
    rlse = rlse.reshape(b, h, sq)
    dq = K.flash_bwd_dq(q, k, v, do, rlse, delta, scale, causal)
    dk, dv = K.flash_bwd_dkv(q, k, v, do, rlse, delta, scale, causal)
    torch.cuda.synchronize()
    after = K.launch_counts()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert after[name] == before[name] + 1
    args = [_bhsd(x) for x in (q, k, v, do)] + [
        rlse.reshape(b * h, sq), delta.reshape(b * h, sq), scale, causal]
    rq = K.flash_bwd_dq_reference(*args)
    rk, rv = K.flash_bwd_dkv_reference(*args)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)
    for got, want in ((o, ro), (dq, rq), (dk, rk), (dv, rv)):
        torch.testing.assert_close(got.float(), _bshd(want, b, h).float(),
                                   rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,d", [
    (1, 1, 128), (65, 65, 128), (129, 129, 16), (1000, 1000, 128),
    (129, 65, 64), (65, 129, 128), (1, 129, 16), (63, 1000, 96),
    (512, 512, 64), (300, 77, 32), (1, 1000, 128)])
def test_flash_kernels_in_float16_on_card(causal, sq, sk, d):
    """The f16 instantiation of the Hopper forward, dQ and dK/dV at the
    sides of their tiles and at head dims 128 to 16, against the plain
    versions as :func:`test_flash_kernels_match_plain_on_card` holds bf16
    (rtol/atol 2e-2; f16 rounds finer than bf16)."""
    test_flash_kernels_match_plain_on_card("float16", causal, sq, sk, d)


@pytest.mark.cuda
def test_float16_attention_takes_the_flash_kernels_on_card():
    """``scaled_dot_product_attention`` on f16 CUDA tensors runs the flash
    forward (and its backward the dQ and dK/dV kernels), not the plain
    chain, and agrees with the chain run on the same values in f32
    (rtol/atol 2e-2)."""
    _need_cuda()
    from paddle_tpu_torch.nn import functional as PF
    g = torch.Generator(device="cuda").manual_seed(41)
    q, k, v = (torch.randn(2, 100, 4, 64, device="cuda", generator=g)
               .half().requires_grad_(True) for _ in range(3))
    before = K.launch_counts()
    out = PF.scaled_dot_product_attention(q, k, v, is_causal=True,
                                          training=False)
    out.float().sum().backward()
    torch.cuda.synchronize()
    after = K.launch_counts()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert after[name] == before[name] + 1, name
    assert out.dtype == torch.float16
    want = PF.scaled_dot_product_attention(
        *(t.detach().float() for t in (q, k, v)), attn_mask=torch.ones(
            100, 100, dtype=torch.bool, device="cuda").tril())
    torch.testing.assert_close(out.float(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("float32", 32), ("bfloat16", 128)])
def test_flash_attention_bshd_gradients_on_card_through_strided_views(
        dtype, d):
    """The autograd Function on q/k/v views of one fused [B, S, 3*H*D]
    tensor (the GPT's layout) against autograd through the plain chain in
    f32 on the same values (f32: rtol/atol 1e-4; bf16: rtol/atol 2e-2
    elementwise, a few bf16 roundings, and 1e-2 on the error's norm)."""
    _need_cuda()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(5)
    b, s, h = 2, 130, 4
    qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=g).to(dt)
    qkv.requires_grad_(True)
    ct = torch.randn(b, s, h, d, device="cuda", generator=g).to(dt)

    def split(t):
        return [t[..., i * h * d:(i + 1) * h * d].reshape(b, s, h, d)
                for i in range(3)]

    got = torch.autograd.grad((K.flash_attention_bshd(*split(qkv)).float()
                               * ct.float()).sum(), qkv)[0]
    ref = qkv.detach().float().requires_grad_(True)
    q, k, v = split(ref)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    causal = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
    o = torch.einsum("bhqk,bkhd->bqhd", sc.masked_fill(~causal, -1e30)
                     .softmax(-1), v)
    want = torch.autograd.grad((o * ct.float()).sum(), ref)[0]
    tol = 1e-4 if dt == torch.float32 else 2e-2
    assert got.dtype == dt
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    if dt == torch.bfloat16:
        assert float((got.float() - want).norm() / want.norm()) <= 1e-2


@pytest.mark.cuda
def test_fused_adamw_kernel_matches_plain_on_card():
    """One multi-tensor launch over f32 tensors of mixed size and one bf16
    tensor, each with its own lr/wd/bias corrections, against the plain
    version tensor by tensor (f32 w, m, v within 1e-6; bf16 w within one
    bf16 rounding)."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(6)
    shapes = [(1000, 33), (5,), (70000,), (64, 64)]
    ws = [torch.randn(s, device="cuda", generator=g) for s in shapes]
    ws.append(torch.randn(300, device="cuda", generator=g).bfloat16())
    gs = [torch.randn(w.shape, device="cuda", generator=g) for w in ws]
    ms = [0.1 * torch.randn(w.shape, device="cuda", generator=g)
          for w in ws]
    vs = [torch.rand(w.shape, device="cuda", generator=g) for w in ws]
    n = len(ws)
    lrs = [1e-3 * (i + 1) for i in range(n)]
    wds = [0.1 * (i % 2) for i in range(n)]
    bc1 = [1.0 / (1 - 0.9 ** (i + 1)) for i in range(n)]
    bc2 = [1.0 / (1 - 0.95 ** (i + 1)) for i in range(n)]
    want = [K.fused_adamw_reference(w, gr, m, v, lr, 0.9, 0.95, 1e-8, wd,
                                    c1, c2)
            for w, gr, m, v, lr, wd, c1, c2 in zip(ws, gs, ms, vs, lrs, wds,
                                                   bc1, bc2)]
    before = K.fused_adamw.launches
    K.fused_adamw(ws, gs, ms, vs, lrs, 0.9, 0.95, 1e-8, wds, bc1, bc2)
    torch.cuda.synchronize()
    assert K.fused_adamw.launches == before + 1
    for (w2, m2, v2), w, m, v in zip(want, ws, ms, vs):
        wtol = 1e-6 if w.dtype == torch.float32 else 8e-3
        torch.testing.assert_close(w.float(), w2.float(), rtol=wtol,
                                   atol=wtol)
        torch.testing.assert_close(m, m2, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(v, v2, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kvh,d", [(16, 128), (4, 128), (2, 64)])
def test_paged_attention_kernel_matches_plain_on_card(dtype, kvh, d):
    """The paged decode kernel against its plain version: contexts that
    end mid-page, on a page edge and at the full ``max_pages * page``, a
    row with context 0 (exact zeros), tables padded with -1 (f32: atol
    1e-4; bf16: rtol/atol 2e-2)."""
    _need_cuda()
    dt = getattr(torch, dtype)
    tol = 1e-4 if dt == torch.float32 else 2e-2
    g = torch.Generator(device="cuda").manual_seed(kvh + d)
    page, num_pages, max_pages, H = 16, 40, 6, 16
    ctx = torch.tensor([37, 32, max_pages * page, 0, 1, 95], device="cuda",
                       dtype=torch.int32)
    B = ctx.shape[0]
    bt = torch.full((B, max_pages), -1, dtype=torch.int32, device="cuda")
    perm = torch.randperm(num_pages - 1, device="cuda", generator=g) + 1
    used = 0
    for r in range(B):
        n = -(-int(ctx[r]) // page)
        bt[r, :n] = perm[used:used + n]
        used += n
    q = torch.randn(B, H, d, device="cuda", generator=g).to(dt)
    k, v = (torch.randn(num_pages, page, kvh, d, device="cuda",
                        generator=g).to(dt) for _ in range(2))
    before = K.paged_attention.launches
    out = K.paged_attention(q, k, v, bt, ctx)
    torch.cuda.synchronize()
    assert K.paged_attention.launches == before + 1
    assert bool((out[3] == 0).all())
    torch.testing.assert_close(out.float(), K.paged_attention_reference(
        q, k, v, bt, ctx).float(), rtol=tol, atol=tol)


def _paged_rows(ctx, H, KVH, D, dtype, seed, page=16, max_pages=64):
    """A decode launch over contexts ``ctx``: each row's pages a slice of
    a random permutation of the pool's, tables padded with -1."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    need = [-(-c // page) for c in ctx]
    num_pages = sum(need) + 2
    perm = (torch.randperm(num_pages - 1, device="cuda", generator=g)
            + 1).int()
    bt = torch.full((len(ctx), max_pages), -1, dtype=torch.int32,
                    device="cuda")
    used = 0
    for r, n in enumerate(need):
        bt[r, :n] = perm[used:used + n]
        used += n
    q = torch.randn(len(ctx), H, D, device="cuda", generator=g).to(dtype)
    k, v = (torch.randn(num_pages, page, KVH, D, device="cuda",
                        generator=g).to(dtype) for _ in range(2))
    return q, k, v, bt, torch.tensor(ctx, dtype=torch.int32, device="cuda")


def _check_paged_twice(args, tol):
    """Two launches in a row on the cached split scratch (the second with a
    new q): both match the plain version, the context-0 rows are exactly
    zero, and the scratch keeps its pointers (the tickets were reset)."""
    q, rest, ctx = args[0], args[1:], args[4]
    before = K.paged_attention.launches
    ptrs = None
    for call in range(2):
        if call:
            q = torch.randn_like(q.float()).to(q.dtype)
        out = K.paged_attention(q, *rest)
        torch.cuda.synchronize()
        want = K.paged_attention_reference(q, *rest)
        torch.testing.assert_close(out.float(), want.float(), rtol=tol,
                                   atol=tol)
        assert bool((out[ctx == 0] == 0).all())
        now = [t.data_ptr() for t in PA._scratch.get(q.device, [])
               if t is not None]
        assert ptrs is None or now == ptrs
        ptrs = now
    assert K.paged_attention.launches == before + 2


# rows a launch at gpt_1p3b's widths (H = KVH = 16, D 128): B 1 is the
# widest split (16 of 4 tiles at 1024 keys), B 16 the serving engine's
# decode step, B 33 a single split; the plan's split count falls with B
_SPLIT_ROWS = [1, 2, 3, 4, 6, 9, 16, 33]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", _SPLIT_ROWS)
def test_paged_attention_split_boundaries_match_plain_on_card(dtype, B):
    """The split-K paged kernel at gpt_1p3b's widths over every split
    count the plan gives as B grows (row 0 the full 1024 keys), with
    contexts one key either side of the tile edges where a row's used
    splits change (16 u - 1, 16 u, 16 u + 1 for u = 1, n_split - 1,
    n_split, n_split + 1, 2 n_split) and a context-0 row; two calls in a
    row on the cached scratch (f32: atol/rtol 1e-4; bf16: 2e-2)."""
    _need_cuda()
    dt = getattr(torch, dtype)
    tol = 1e-4 if dt == torch.float32 else 2e-2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_split = PA.launch_plan(B, 16, 16, 128, 64, 16, sms)["n_split"]
    edges = [c for u in (1, n_split - 1, n_split, n_split + 1, 2 * n_split)
             for c in (16 * u - 1, 16 * u, 16 * u + 1) if 0 <= c <= 1024]
    pool = [1024, 0] + edges + [1023, 500]
    ctx = [pool[i % len(pool)] for i in range(B)]
    _check_paged_twice(_paged_rows(ctx, 16, 16, 128, dt, seed=B), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("G", [1, 3, 4, 8, 16])
def test_paged_attention_groups_match_plain_on_card(dtype, d, G):
    """The paged kernel at G 1, 4 and 8 query heads a KV head (one block
    each), G 3 (a block of 4 with one head idle) and G 16 (two head
    groups), D 64 and 128, over contexts that cross pages, end on a page
    edge, fill the table, are 0 (exactly zero out) and 1; two calls in a
    row on the cached scratch (f32: atol/rtol 1e-4; bf16: 2e-2)."""
    _need_cuda()
    dt = getattr(torch, dtype)
    tol = 1e-4 if dt == torch.float32 else 2e-2
    args = _paged_rows([300, 32, 1024, 0, 1, 17], 2 * G, 2, d, dt,
                       seed=G * d)
    _check_paged_twice(args, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("rows,h", [(300, 2048), (7, 96)])
def test_rms_norm_kernel_matches_plain_on_card(dtype, with_bias, rows, h):
    """The Triton RMSNorm against its plain version, H a power of two and
    not (f32: atol 1e-4; bf16: rtol/atol 2e-2)."""
    _need_cuda()
    dt = getattr(torch, dtype)
    tol = 1e-4 if dt == torch.float32 else 2e-2
    g = torch.Generator(device="cuda").manual_seed(rows + h)
    x = (torch.randn(rows, h, device="cuda", generator=g) * 2 + 1).to(dt)
    w = (1 + 0.1 * torch.randn(h, device="cuda", generator=g)).to(dt)
    b = (0.1 * torch.randn(h, device="cuda", generator=g)).to(dt) \
        if with_bias else None
    before = K.rms_norm.launches
    out = K.rms_norm(x, w, b, 1e-6)
    torch.cuda.synchronize()
    assert K.rms_norm.launches == before + 1
    torch.testing.assert_close(out.float(), K.rms_norm_reference(
        x, w, b, 1e-6).float(), rtol=tol, atol=tol)


def _ragged_rows(rows, G, D, dtype, seed, pad=0, unused=1, page=16,
                 max_pages=64, KVH=2):
    """A ragged launch from ``rows`` = [(row_len, kv_len), ...] laid back
    to back from token 0, then ``pad`` pad tokens and ``unused`` unused
    rows (row_starts = T). Every table is padded with -1 past its row's
    pages; pages are a random permutation of the pool's."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    H = KVH * G
    T = sum(rl for rl, _ in rows) + pad
    need = [-(-kl // page) for _, kl in rows]
    num_pages = sum(need) + 2
    perm = (torch.randperm(num_pages - 1, device="cuda", generator=g)
            + 1).int()
    R = len(rows) + unused
    bt = torch.full((R, max_pages), -1, dtype=torch.int32, device="cuda")
    rs, rl, kl, used, cur = [], [], [], 0, 0
    for i, (n, c) in enumerate(rows):
        bt[i, :need[i]] = perm[used:used + need[i]]
        used += need[i]
        rs.append(cur)
        rl.append(n)
        kl.append(c)
        cur += n
    rs += [T] * unused
    rl += [0] * unused
    kl += [0] * unused
    meta = [torch.tensor(x, dtype=torch.int32, device="cuda")
            for x in (rs, rl, kl)]
    q = torch.randn(T, H, D, device="cuda", generator=g).to(dtype)
    k, v = (torch.randn(num_pages, page, KVH, D, device="cuda",
                        generator=g).to(dtype) for _ in range(2))
    return (q, k, v, *meta, bt), cur


# decode contexts 1..1024 over 64 pages of 16: every split count of the
# 128-key splits, contexts ending on a page and on a split boundary
_DECODE16 = [(1, c) for c in (1, 15, 16, 17, 127, 128, 129, 255, 256, 257,
                              500, 511, 512, 768, 1000, 1024)]
_RAGGED_CASES = {
    "decode16": (_DECODE16, 0),
    # a 150-token segment (more than one tile at every G) starting
    # mid-page behind a 37-token prefix, and a pad tail
    "prefill_mid_page": ([(150, 187)], 10),
    # decode rows, a whole prompt, a mid-page chunk, a longer chunk, a row
    # whose token has context 0, and a pad tail
    "mixed": ([(1, 300), (1, 17), (40, 40), (29, 66), (200, 456), (1, 0)],
              23),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("case", sorted(_RAGGED_CASES))
def test_ragged_kernel_layouts_match_plain_on_card(dtype, d, G, case):
    """The ragged kernel against its plain version over decode rounds at
    every split count, a prefill segment longer than a tile starting
    mid-page, and decode rows and chunks mixed in one launch, at G 1, 4
    and 8, D 64 and 128 (f32: atol/rtol 1e-4; bf16: 2e-2). Pad tokens,
    the unused row's and the context-0 token come out exactly 0. Two
    calls in a row reuse the cached split scratch."""
    _need_cuda()
    dt = getattr(torch, dtype)
    tol = 1e-4 if dt == torch.float32 else 2e-2
    rows, pad = _RAGGED_CASES[case]
    args, n_valid = _ragged_rows(rows, G, d, dt, seed=G * d + len(case),
                                 pad=pad)
    before = K.ragged_paged_attention.launches
    for call in range(2):
        if call:
            args = (torch.randn_like(args[0].float()).to(dt),) + args[1:]
        out = K.ragged_paged_attention(*args)
        torch.cuda.synchronize()
        want = K.ragged_paged_attention_reference(*args)
        torch.testing.assert_close(out.float(), want.float(), rtol=tol,
                                   atol=tol)
        assert bool((out[n_valid:] == 0).all())
        if case == "mixed":
            assert bool((out[n_valid - 1] == 0).all())  # context 0
    assert K.ragged_paged_attention.launches == before + 2


# ------------------------------------------------ the serving round's graphs
def _two_layer_1p3b(dtype, use_rms_norm=False):
    """A 2-layer GPT at ``gpt_1p3b`` widths (hidden 2048, 16 heads, vocab
    50304) with random weights from a seed."""
    import paddle_tpu_torch as pt
    cfg = pt.gpt_1p3b(dropout=0.0, use_rms_norm=use_rms_norm)
    cfg.num_layers = 2
    return pt.GPTForCausalLM(cfg, dtype=dtype, seed=1)


def _engine_kw(ragged):
    kw = dict(page_size=16, num_pages=96, max_slots=4, ragged=ragged)
    if ragged:
        kw["prefill_chunk"] = 32
    return kw


_PROMPT_LENS = (37, 100, 5, 64)


def _serve(eng, vocab, seed=0):
    """The same prompts, submitted in two waves so rounds mix prefill
    chunks with decode rows -> (tokens per request, captured logits)."""
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(1, vocab, size=n).tolist() for n in _PROMPT_LENS]
    eng.capture_logits = []
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts[:2]]
    eng.step()
    reqs += [eng.submit(p, max_new_tokens=6) for p in prompts[2:]]
    eng.run_until_idle()
    return [r.result(60) for r in reqs], eng.capture_logits


def _assert_same_run(got, want):
    """Tokens equal and every captured logit row equal -> the largest
    absolute logit difference (0 when equal)."""
    assert got[0] == want[0]
    assert len(got[1]) == len(want[1]) > 0
    worst = 0.0
    for (gmap, gl), (wmap, wl) in zip(got[1], want[1]):
        assert sorted(gmap) == sorted(wmap)        # slots (ids differ)
        for slot in gmap:
            worst = max(worst, float(np.abs(gl[slot] - wl[slot]).max()))
    print(f"largest logit difference, replay vs eager: {worst}")
    assert worst == 0.0, f"replayed logits differ from eager by {worst}"
    return worst


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graph_replay_serves_as_the_eager_round_on_card(dtype, ragged):
    """``jit=True`` (a CUDA graph per token pad, or per prefill and chunk
    bucket and of the decode step, captured at its first round and
    replayed after) and ``jit=False`` (eager rounds) serve the same
    prompts on one model: the same greedy tokens and bit-equal logits
    (the same kernels at the same shapes)."""
    _need_cuda()
    from paddle_tpu_torch import ServingEngine
    model = _two_layer_1p3b(getattr(torch, dtype))
    vocab = model.config.vocab_size
    runs = {}
    for jit in (True, False):
        eng = ServingEngine(model, jit=jit, **_engine_kw(ragged))
        runs[jit] = _serve(eng, vocab)
        st = eng.stats()
        assert st["graphs"] == st["distinct_programs"] * jit
        if ragged:
            assert st["distinct_programs"] == len(st["ragged_token_pads"])
        eng.close()
    _assert_same_run(runs[True], runs[False])


@pytest.mark.cuda
def test_graphs_survive_larger_plans_between_replays_on_card():
    """The graphs point into the engines' own split scratch: larger
    ragged and paged plans launched elsewhere after the captures grow
    (reallocate) the kernels' shared caches, the freed memory is
    overwritten, and the replays still equal the eager rounds."""
    _need_cuda()
    from paddle_tpu_torch import ServingEngine
    dt = torch.bfloat16
    model = _two_layer_1p3b(dt)
    vocab = model.config.vocab_size
    g = torch.Generator(device="cuda").manual_seed(3)

    def ragged_launch(T, R):
        pools = [torch.randn(64, 16, 16, 128, device="cuda",
                             generator=g).to(dt) for _ in range(2)]
        q = torch.randn(T, 16, 128, device="cuda", generator=g).to(dt)
        rs = torch.arange(R, dtype=torch.int32, device="cuda")
        rs[-1] = T                                     # pad tail
        ones = torch.ones(R, dtype=torch.int32, device="cuda")
        bt = torch.randint(1, 64, (R, 64), dtype=torch.int32, device="cuda",
                           generator=g)
        K.ragged_paged_attention(q, *pools, rs, ones, ones * 900, bt)

    def paged_launch(B):
        q, k, v, bt, ctx = _paged_rows([700] * B, 16, 16, 128, dt, seed=B)
        K.paged_attention(q, k, v, bt, ctx)

    ragged_launch(8, 4)              # the shared caches hold small plans
    paged_launch(1)
    engines = {}
    for ragged in (True, False):
        eng = ServingEngine(model, jit=True, **_engine_kw(ragged))
        eng.warm_ragged()
        _serve(eng, vocab, seed=5)                     # captures the graphs
        engines[ragged] = eng
    ragged_launch(512, 16)             # larger plans regrow both caches
    paged_launch(32)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    junk = torch.full((1 << 28,), float("nan"), device="cuda")
    del junk
    for ragged, eng in engines.items():
        eager = ServingEngine(model, jit=False, **_engine_kw(ragged))
        _serve(eager, vocab, seed=5)           # the same history of slots
        _assert_same_run(_serve(eng, vocab), _serve(eager, vocab))
        eng.close()
        eager.close()


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [True, False])
def test_replays_add_their_captured_launches_on_card(ragged):
    """``launch_counts()`` stays the launches issued on the card: a
    capture takes back what its wrappers counted, and N replays add N
    times what it recorded (attention once a layer, the norm 2L + 1
    times a round)."""
    _need_cuda()
    from paddle_tpu_torch import ServingEngine
    model = _two_layer_1p3b(torch.bfloat16, use_rms_norm=not ragged)
    eng = ServingEngine(model, jit=True, **_engine_kw(ragged))
    R, maxp, L = eng.max_slots, eng.max_pages, 2
    zeros = np.zeros(R, np.int32)
    bt = np.zeros((R, maxp), np.int32)
    if ragged:
        T = 16
        run = lambda: eng._ragged_fn(np.zeros(T, np.int32),  # noqa: E731
                                     np.full(R, T, np.int32), zeros, zeros,
                                     bt)
        want = {"ragged_paged_attention": L, "layer_norm": 2 * L + 1}
        key = ("ragged", T)
    else:
        run = lambda: eng._decode_fn(zeros, zeros, bt)  # noqa: E731
        want = {"paged_attention": L, "rms_norm": 2 * L + 1}
        key = ("decode",)
    run()                         # warm-up and capture, then one replay
    assert eng._rounds._progs[key].captured.launches == want
    K.reset_launch_counts()
    n = 5
    for _ in range(n):
        run()
    torch.cuda.synchronize()
    counts = {k: v for k, v in K.launch_counts().items() if v}
    assert counts == {k: n * v for k, v in want.items()}
    eng.close()


@pytest.mark.cuda
def test_replayed_prefill_and_chunk_buckets_equal_eager_rounds_on_card():
    """A dense prefill bucket and a chunk bucket of the bucketed engine,
    replayed (``jit=True``, captured at their first round) and eager
    (``jit=False``) on the same inputs: tokens, logit rows and the pools
    they wrote bit-equal; each replay runs the flash forward (prefill) and
    RMSNorm kernels it captured, and the prefill zeroes the tail of its
    last page."""
    _need_cuda()
    from paddle_tpu_torch import ServingEngine
    model = _two_layer_1p3b(torch.bfloat16, use_rms_norm=True)
    eng = ServingEngine(model, jit=True, **_engine_kw(False))
    L, rng = 2, np.random.RandomState(4)
    nb, sb, lens = 2, 32, np.array([29, 17], np.int32)
    ids = rng.randint(1, 50304, (nb, sb)).astype(np.int32)
    bt = np.zeros((nb, 3), np.int32)
    bt[0], bt[1, :2] = [5, 6, 7], [9, 10]
    kv = eng.kv
    kv.k[0][1:].normal_()                      # old values to overwrite
    rounds = {
        ("prefill", nb, sb): (eng._prefill_fn, (ids, lens, bt)),
        # a chunk of 8 tokens a row at positions 29 and 17, over the
        # pages the prefill wrote
        ("chunk", nb, 8): (eng._chunk_fn, (
            rng.randint(1, 50304, (nb, 8)).astype(np.int32),
            lens, np.array([8, 5], np.int32),
            np.pad(bt, ((0, 0), (0, eng.max_pages - 3)))))}
    for key, (run, args) in rounds.items():
        tok_r, rows_r = run(*args, need_rows=True, jit=True)
        pools = [t.clone() for t in kv.k + kv.v]
        tok_e, rows_e = run(*args, need_rows=True, jit=False)
        torch.cuda.synchronize()
        assert tok_r == tok_e
        np.testing.assert_array_equal(rows_r, rows_e)
        for a, b in zip(pools, kv.k + kv.v):
            assert torch.equal(a, b), key
        want = {"rms_norm": 2 * L + 1}
        if key[0] == "prefill":
            want["flash_fwd"] = L
            # row 0: 29 tokens in pages 5, 6 (16 + 13), zeros after
            assert (kv.k[0][6, 13:] == 0).all() and (kv.k[0][7] == 0).all()
            assert not (kv.k[0][6, :13] == 0).all()
        assert eng._rounds._progs[key].captured.launches == want
    eng.close()


@pytest.mark.cuda
def test_chunk_bucket_pad_row_replays_bit_equal_on_card():
    """A chunk bucket of 4 rows with 3 real rows and a pad row (length 0,
    all-zero table), replayed and eager in turn ten times: every row bit
    equal to the first run, the pad row's included. The pad row attends
    over the scrap page, where the round's padding tokens write zeros in
    parallel, so its output does not depend on which duplicate write
    lands last."""
    _need_cuda()
    from paddle_tpu_torch import ServingEngine
    model = _two_layer_1p3b(torch.bfloat16, use_rms_norm=True)
    eng = ServingEngine(model, jit=True, **_engine_kw(False))
    rng = np.random.RandomState(6)
    for pool in eng.kv.k + eng.kv.v:
        pool[1:].normal_()                     # a prefix in every page
    nb, sb = 4, 64
    tokens = rng.randint(1, 50304, (nb, sb)).astype(np.int32)
    positions = np.array([32, 32, 16, 0], np.int32)
    lens = np.array([53, 42, 60, 0], np.int32)
    bt = np.zeros((nb, eng.max_pages), np.int32)
    bt[0, :6], bt[1, :5], bt[2, :5] = (np.arange(1, 7), np.arange(7, 12),
                                       np.arange(12, 17))
    args = (tokens, positions, lens, bt)
    first = None
    for i in range(10):
        tok, rows = eng._chunk_fn(*args, need_rows=True, jit=i % 2 == 0)
        if first is None:
            first = tok, rows
            continue
        assert tok == first[0]
        np.testing.assert_array_equal(rows, first[1])
    torch.cuda.synchronize()
    for pool in eng.kv.k + eng.kv.v:
        assert (pool[0] == 0).all()
    eng.close()


def _generate_inputs(model, B=2, P=16, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        1, model.config.vocab_size, (B, P))).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generate_replays_equal_the_eager_static_step_on_card(dtype):
    """The compiled ``generate``: its replayed step (one graph, captured
    after one eager warm-up step) gives the eager static step's tokens bit
    for bit, with and without an eos that stops every row early (the
    columns after it stay 0); LayerNorm launches 2L + 1 times a forward
    whether replayed or eager. In f32 the dense-cache loop (the flash
    forward at Sq = 1, L launches a forward) gives the same greedy tokens,
    as JAX's test holds the two on the CPU."""
    _need_cuda()
    from paddle_tpu_torch.models.generate import generate_compiled
    model = _two_layer_1p3b(getattr(torch, dtype))
    ids = _generate_inputs(model)
    L, N = 2, 24
    K.reset_launch_counts()
    out = model.generate(ids, max_new_tokens=N, temperature=0.0)
    assert model.decode_programs.graphs == 1
    eager = generate_compiled(model, ids, N, None, replay=False)
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert K.launch_counts()["layer_norm"] == 2 * (2 * L + 1) * N
    eos = int(out[0, 18])
    rows = [set(r[16:].tolist()) for r in out]
    if all(eos in r for r in rows):
        got = model.generate(ids, max_new_tokens=N, temperature=0.0,
                             eos_token_id=eos)
        assert torch.equal(got, generate_compiled(model, ids, N, eos,
                                                  replay=False))
    if dtype == "float32":
        K.reset_launch_counts()
        dense = model.generate(ids, max_new_tokens=N, temperature=0.0,
                               compiled=False)
        torch.cuda.synchronize()
        assert torch.equal(dense, out)
        counts = K.launch_counts()
        assert counts["flash_fwd"] == L * (N + 1)
        assert counts["layer_norm"] == (2 * L + 1) * (N + 1)


@pytest.mark.cuda
def test_fused_adamw_master_and_bf16_moment_modes_on_card():
    """One launch over a mixed table: f32 entries, a bf16 w with f32
    moments, master-mode entries (f32 master and moments, bf16 parameter
    written in the same pass) and bf16-moment entries, against the plain
    version tensor by tensor: f32 values within 1e-6, bf16 ones within one
    bf16 rounding; a master-mode parameter is its new master rounded to
    nearest even, exactly."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(9)
    bf = torch.bfloat16
    # (w dtype, g dtype, moment dtype, master mode)
    modes = [(torch.float32, torch.float32, torch.float32, False),
             (bf, bf, torch.float32, False),
             (torch.float32, bf, torch.float32, True),
             (bf, bf, bf, False)]
    shapes = [(1000, 33), (5,), (70000,), (64, 64), (3,), (4097,)]
    ws, gs, ms, vs, ps = [], [], [], [], []
    for i, sh in enumerate(shapes * 2):
        wd_, gd_, md_, master = modes[i % len(modes)]
        w = torch.randn(sh, device="cuda", generator=g)
        p = w.to(bf) if master else None
        ws.append(p.float() if master else w.to(wd_))
        ps.append(p)
        gs.append(torch.randn(sh, device="cuda", generator=g).to(gd_))
        ms.append((0.1 * torch.randn(sh, device="cuda", generator=g))
                  .to(md_))
        vs.append(torch.rand(sh, device="cuda", generator=g).to(md_))
    n = len(ws)
    lrs = [1e-3 * (i + 1) for i in range(n)]
    wds = [0.1 * (i % 2) for i in range(n)]
    bc1 = [1.0 / (1 - 0.9 ** (i + 1)) for i in range(n)]
    bc2 = [1.0 / (1 - 0.95 ** (i + 1)) for i in range(n)]
    want = [K.fused_adamw_reference(w, gr, m, v, lr, 0.9, 0.95, 1e-8, wd,
                                    c1, c2)
            for w, gr, m, v, lr, wd, c1, c2 in zip(ws, gs, ms, vs, lrs, wds,
                                                   bc1, bc2)]
    before = K.fused_adamw.launches
    K.fused_adamw(ws, gs, ms, vs, lrs, 0.9, 0.95, 1e-8, wds, bc1, bc2,
                  params=ps)
    torch.cuda.synchronize()
    assert K.fused_adamw.launches == before + 1
    for (w2, m2, v2), w, m, v, p in zip(want, ws, ms, vs, ps):
        for got, ref in ((w, w2), (m, m2), (v, v2)):
            assert got.dtype == ref.dtype
            tol = 1e-6 if got.dtype == torch.float32 else 8e-3
            torch.testing.assert_close(got.float(), ref.float(), rtol=tol,
                                       atol=tol)
        if p is not None:
            assert torch.equal(p, w.to(bf))


def _o2_train(recompute, steps=3):
    """A 2-layer GPT at gpt_1p3b widths trained ``steps`` O2 steps (AdamW
    with master weights, global-norm clip, warm-up schedule) at B 2 x
    S 512 -> (losses, the bytes the last step's forward left allocated
    for its backward, launch counts)."""
    import paddle_tpu_torch as pt
    cfg = pt.gpt_1p3b(dropout=0.0, recompute=recompute)
    cfg.num_layers = 2
    model = pt.GPTForCausalLM(cfg, seed=2).train()
    sched = pt.optimizer.lr.LinearWarmup(1e-4, 2, 0.0, 1e-4)
    opt = pt.AdamW(learning_rate=sched, parameters=model.parameters(),
                   multi_precision=True,
                   grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
    pt.amp.decorate(model, opt, level="O2")
    rng = np.random.RandomState(3)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 512))).cuda()
    crit = pt.GPTPretrainingCriterion(cfg)
    K.reset_launch_counts()
    losses = []
    for _ in range(steps):
        before = torch.cuda.memory_allocated()
        with pt.auto_cast(level="O2", dtype="bfloat16"):
            loss = crit(model(ids), ids)
        held = torch.cuda.memory_allocated() - before
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        losses.append(loss.item())
    torch.cuda.synchronize()
    return losses, held, K.launch_counts()


@pytest.mark.cuda
def test_o2_step_launches_adamw_once_and_recompute_matches_on_card():
    """O2 training on the card: one fused AdamW launch a step, the flash
    forward once a layer (twice with recompute, once more in the replay)
    and LayerNorm 2L + 1 times (4L + 1 with recompute); recompute's
    losses equal the run without it within 1e-3 (a reduction that sums
    in another order each run could move them) while its forward holds
    fewer bytes for the backward: at this size the step's peak is the
    complete gradients at the end of the backward either way, and
    ``chip_smoke.py`` phase 13 shows the peak fall at full depth."""
    _need_cuda()
    steps, L = 3, 2
    plain, plain_held, plain_n = _o2_train(False, steps)
    remat, remat_held, remat_n = _o2_train(True, steps)
    assert plain_n["fused_adamw"] == remat_n["fused_adamw"] == steps
    assert plain_n["flash_fwd"] == steps * L
    assert remat_n["flash_fwd"] == 2 * steps * L
    assert plain_n["layer_norm"] == steps * (2 * L + 1)
    assert remat_n["layer_norm"] == steps * (4 * L + 1)
    assert plain_n["flash_bwd_dq"] == remat_n["flash_bwd_dq"] == steps * L
    assert all(np.isfinite(plain)) and plain[-1] < plain[0]
    np.testing.assert_allclose(remat, plain, rtol=0, atol=1e-3)
    assert remat_held < plain_held


# ------------------------------------------- the engine's operations
def _alone(eng, prompt, new, rounds_before, move=None):
    """``prompt`` alone on ``eng`` for ``rounds_before`` rounds, then
    ``move(req)`` (-> the engine it is on) if given, then to the end with
    ``capture_logits`` on -> (tokens, the request's logit rows)."""
    req = eng.submit(prompt, max_new_tokens=new)
    for _ in range(rounds_before):
        eng.step()
    on = eng if move is None else move(req)
    on.capture_logits = []
    on.run_until_idle()
    rows = np.stack([cap[next(s for s, r in m.items()
                              if r == req.request_id)]
                     for m, cap in on.capture_logits])
    return req.result(1), rows


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [True, False])
def test_adopt_then_replay_equals_unmigrated_on_card(ragged):
    """A request moved mid-decode between two engines on the card
    (``fleet.migrate_request``): B's snapshot equals A's payload bit for
    bit (the gathers and the writes run in order with the replays on one
    stream), and B's replayed continuation gives the tokens and the
    bit-equal logits of the same request run unmigrated on A."""
    _need_cuda()
    from paddle_tpu_torch import ServingEngine
    from paddle_tpu_torch.serving.fleet import migrate_request
    model = _two_layer_1p3b(torch.bfloat16, use_rms_norm=not ragged)
    A = ServingEngine(model, jit=True, **_engine_kw(ragged))
    B = ServingEngine(model, jit=True, **_engine_kw(ragged))
    prompt = np.random.RandomState(5).randint(1, 50304, size=40).tolist()
    payload, snap = [], []

    def move(req):
        payload.extend(A.snapshot_kv(req))
        assert migrate_request(A, B, req) == "migrated"
        snap.extend(B.snapshot_kv(req))
        return B

    toks, rows = _alone(A, prompt, 12, 4, move)
    A.prefix.clear()
    ref_toks, ref_rows = _alone(A, prompt, 12, 4)
    assert payload[0][0].is_pinned() and payload[0][0].dtype == torch.bfloat16
    assert snap[2] == payload[2] > len(prompt)
    for a, b in zip(payload[0] + payload[1], snap[0] + snap[1]):
        assert torch.equal(a, b)
    assert toks == ref_toks
    assert rows.shape == ref_rows.shape and np.array_equal(rows, ref_rows)
    A.close()
    B.close()


@pytest.mark.cuda
def test_abort_frees_pages_while_a_replayed_row_goes_on_on_card():
    """Aborting one of two co-resident requests between replayed rounds
    frees its slot and pages (refcount 0) at once; the other request's
    tokens equal its solo run's."""
    _need_cuda()
    from paddle_tpu_torch import ServingEngine
    model = _two_layer_1p3b(torch.bfloat16)
    rng = np.random.RandomState(6)
    keep_p, drop_p = (rng.randint(1, 50304, size=n).tolist()
                      for n in (30, 50))
    solo = ServingEngine(model, jit=True, **_engine_kw(True))
    base = solo.generate(keep_p, max_new_tokens=10)
    solo.close()
    eng = ServingEngine(model, jit=True, **_engine_kw(True))
    fired = []
    keep = eng.submit(keep_p, max_new_tokens=10,
                      on_done=lambda r: fired.append("keep"))
    drop = eng.submit(drop_p, max_new_tokens=10,
                      on_done=lambda r: fired.append("drop"))
    for _ in range(4):
        eng.step()
    assert drop.state == "active" and keep.state == "active"
    pages = list(drop.pages)
    assert eng.abort_request(drop) is True
    assert drop.slot is None and not drop.pages
    assert all(eng.kv.allocator.refcount(p) == 0 for p in pages)
    eng.run_until_idle()
    assert keep.result(1) == base
    assert fired == ["keep"] and drop.state == "aborted"
    eng.close()


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [True, False])
def test_gate_measures_both_and_keeps_the_kernel_on_card(ragged):
    """``attn_backend="auto"`` on the card times the plain version and
    the kernel at the engine's launch shape, keeps the kernel and its next
    round launches it; ``"xla"`` raises."""
    _need_cuda()
    from paddle_tpu_torch import ServingEngine
    model = _two_layer_1p3b(torch.bfloat16, use_rms_norm=not ragged)
    eng = ServingEngine(model, attn_backend="auto", jit=False,
                        **_engine_kw(ragged))
    ab = eng.stats()["attn_ab"]
    assert eng.attn_backend == ab["backend"] == "pallas"
    assert ab["xla_ms"] > 0 and ab["pallas_ms"] > 0
    K.reset_launch_counts()
    eng.generate([1, 2, 3, 4, 5], max_new_tokens=2)
    torch.cuda.synchronize()
    # ragged: a prefill round and a decode round; bucketed: the dense
    # prefill and one decode step in one round; 2 layers each
    name, want = ("ragged_paged_attention", 4) if ragged \
        else ("paged_attention", 2)
    assert K.launch_counts()[name] == want
    eng.close()
    with pytest.raises(ValueError, match="plain"):
        ServingEngine(model, attn_backend="xla", **_engine_kw(ragged))


# ------------------------------------------------- the other models' shapes
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,d", [
    # BERT-base's encoder (head dim 64), the seq2seq copy task's
    # cross-attention (16) and a head dim 32 cross-attention both ways:
    # every one in the DP = 64 tiles with the upper lanes unused
    (512, 512, 64), (129, 129, 64), (7, 11, 16), (7, 6, 16), (300, 77, 32),
    (77, 300, 32), (1, 33, 32)])
def test_flash_kernels_at_head_dims_64_32_16_on_card(dtype, causal, sq, sk,
                                                     d):
    """The flash trio at the head dims of BERT and the seq2seq model, Sq
    and Sk apart, against the plain versions as
    :func:`test_flash_kernels_match_plain_on_card` holds them."""
    test_flash_kernels_match_plain_on_card(dtype, causal, sq, sk, d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("eps", [1e-12, 1e-5])
def test_layer_norm_at_bert_width_on_card(dtype, eps):
    """LayerNorm at [4096, 768], BERT's width, with the embeddings'
    epsilon and the encoder layers' (f32: 1e-4; bf16: 2e-2)."""
    _need_cuda()
    dt = getattr(torch, dtype)
    tol = 1e-4 if dt == torch.float32 else 2e-2
    g = torch.Generator(device="cuda").manual_seed(30)
    x = (torch.randn(4096, 768, device="cuda", generator=g) * 2 + 1).to(dt)
    w = (1 + 0.1 * torch.randn(768, device="cuda", generator=g)).to(dt)
    b = (0.1 * torch.randn(768, device="cuda", generator=g)).to(dt)
    before = K.layer_norm.launches
    got = K.layer_norm(x, w, b, eps)
    torch.cuda.synchronize()
    assert K.layer_norm.launches == before + 1
    torch.testing.assert_close(got.float(),
                               K.layer_norm_reference(x, w, b, eps).float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
def test_fused_adamw_master_mode_writes_f16_parameters_on_card():
    """Master mode over f16 parameters (type code 2) beside a bf16 one and
    an f32 tensor with f16 gradients, in one launch: f32 masters and
    moments within 1e-6 of the plain version, each 16-bit parameter
    exactly its new master rounded to its type."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(31)
    shapes = [(1000, 33), (70000,), (5,), (64, 64)]
    params = [(0.1 * torch.randn(s, device="cuda", generator=g)).half()
              for s in shapes[:3]]
    params.append((0.1 * torch.randn(shapes[3], device="cuda",
                                     generator=g)).bfloat16())
    ws = [p.float() for p in params] + [
        torch.randn(77, device="cuda", generator=g)]
    gs = [(1e-2 * torch.randn(w.shape, device="cuda", generator=g)).half()
          for w in ws]
    ms = [1e-3 * torch.randn(w.shape, device="cuda", generator=g)
          for w in ws]
    vs = [1e-5 * torch.rand(w.shape, device="cuda", generator=g) for w in ws]
    n = len(ws)
    want = [K.fused_adamw_reference(w, gr, m, v, 1e-3, 0.9, 0.999, 1e-8,
                                    0.01, 2.0, 3.0)
            for w, gr, m, v in zip(ws, gs, ms, vs)]
    before = K.fused_adamw.launches
    K.fused_adamw(ws, gs, ms, vs, [1e-3] * n, 0.9, 0.999, 1e-8, [0.01] * n,
                  [2.0] * n, [3.0] * n, params=params + [None])
    torch.cuda.synchronize()
    assert K.fused_adamw.launches == before + 1
    for (w2, m2, v2), w, m, v in zip(want, ws, ms, vs):
        for got, ref in ((w, w2), (m, m2), (v, v2)):
            torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    for p, w in zip(params, ws):
        assert torch.equal(p, w.to(p.dtype))


@pytest.mark.cuda
def test_resnet18_o2_float16_steps_on_card():
    """``resnet18`` decorated O2 float16 with ``Momentum(multi_precision=
    True)`` and a ``GradScaler``: three steps on one batch with finite,
    falling losses, f16 parameters with f32 masters and finite f16
    running statistics."""
    _need_cuda()
    import paddle_tpu_torch as pt
    model = pt.resnet18(num_classes=10, seed=0)
    opt = pt.Momentum(0.05, 0.9, parameters=model.parameters(),
                      weight_decay=pt.regularizer.L2Decay(1e-4),
                      multi_precision=True)
    model, opt = pt.amp.decorate(model, opt, level="O2", dtype="float16")
    scaler = pt.amp.GradScaler(init_loss_scaling=2.0 ** 15)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(16, 3, 64, 64).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.randint(0, 10, 16)).cuda()
    losses = []
    for _ in range(3):
        with pt.auto_cast(level="O2", dtype="float16"):
            loss = pt.nn.functional.cross_entropy(model(x), y)
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        losses.append(loss.item())
    assert all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
    for p in model.parameters():
        assert p.dtype == torch.float16
        assert torch.equal(p.detach(), opt._master_weights[p].half())
    for b in model.buffers():
        assert b.dtype == torch.float16 and bool(torch.isfinite(b).all())


# ------------------------------------------------ jit.to_static's graphs
def _tiny_gpt_run(staged, steps=5, B=4, S=64):
    """``gpt_tiny`` (2 layers, head dim 16) under ``auto_cast`` O1 bf16
    with ``AdamW`` and a warm-up schedule stepped outside the step ->
    (losses, model, launches of the steps after the second, step)."""
    import paddle_tpu_torch as pt
    cfg = pt.gpt_tiny()
    model = pt.GPTForCausalLM(cfg, seed=3).train()
    sched = pt.optimizer.lr.LinearWarmup(1e-3, 3, 0.0, 1e-3)
    opt = pt.AdamW(learning_rate=sched, parameters=model.parameters(),
                   grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
    crit = pt.GPTPretrainingCriterion(cfg)
    rng = np.random.RandomState(4)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).cuda()

    def train_step(x):
        with pt.auto_cast(level="O1", dtype="bfloat16"):
            loss = crit(model(x), x)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    step = pt.jit.to_static(train_step, capture=(model, opt)) if staged \
        else train_step
    losses = []
    for i in range(steps):
        if i == 2:
            torch.cuda.synchronize()
            K.reset_launch_counts()
        losses.append(step(ids).item())
        sched.step()
    torch.cuda.synchronize()
    return losses, model, K.launch_counts(), step


@pytest.mark.cuda
def test_staged_gpt_step_replays_equal_eager_on_card():
    """The whole step as one CUDA graph (warm-up, capture, replays) gives
    the eager run's losses and weights bit for bit (the same kernels in
    the same order; the schedule's lr reaches every replay through the
    static AdamW table), and each replay adds its captured launches: the
    flash trio once a layer, LayerNorm 2L + 1, AdamW once."""
    _need_cuda()
    el, em, en, _ = _tiny_gpt_run(False)
    sl, sm, sn, step = _tiny_gpt_run(True)
    assert sl == el, (sl, el)
    for a, b in zip(sm.parameters(), em.parameters()):
        assert torch.equal(a, b)
    L, replays = 2, 3
    want = {name: 0 for name in sn}
    want.update({"flash_fwd": replays * L, "flash_bwd_dq": replays * L,
                 "flash_bwd_dkv": replays * L,
                 "layer_norm": replays * (2 * L + 1),
                 "fused_adamw": replays})
    assert sn == want == en
    st = step.stats()
    assert st["warmups"] == 1 and st["graphs"] == 1
    assert st["replays"] == 4 and st["graph_breaks"] == 0


def _sgd_mlp(seed=5):
    import paddle_tpu_torch as pt
    torch.manual_seed(seed)
    m = pt.nn.Sequential(pt.nn.Linear(6, 16), pt.nn.Tanh(),
                         pt.nn.Linear(16, 3)).cuda()
    with torch.no_grad():
        for p in m.parameters():
            p.normal_(0.0, 0.3)
    return m


@pytest.mark.cuda
def test_graph_break_leaves_params_intact_on_card():
    """A step that reads ``float(loss)`` after its update: the first call
    runs eagerly (the warm-up), the capture at the second meets the host
    sync and is thrown away. With ``full_graph=True`` that raises and
    every parameter, Adam moment, ``.grad`` and counter is as the first
    call left it; with ``full_graph=False`` it warns once and the calls
    run eagerly, equal to an eager run bit for bit."""
    _need_cuda()
    import paddle_tpu_torch as pt
    x = torch.randn(8, 6, device="cuda")
    y = torch.randn(8, 3, device="cuda")

    def build(full_graph, staged=True):
        m = _sgd_mlp()
        opt = pt.Adam(learning_rate=0.01, parameters=m.parameters())
        seen = []

        def train_step(xb, yb):
            loss = ((m(xb) - yb) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            seen.append(float(loss))
            return loss

        step = pt.jit.to_static(train_step, capture=(m, opt),
                                full_graph=full_graph) if staged \
            else train_step
        return m, opt, step, seen

    m, opt, step, _ = build(True)
    step(x, y)
    torch.cuda.synchronize()
    params = [p.detach().clone() for p in m.parameters()]
    moments = {k: v.clone() for k, v in opt._accumulators["moment1"].items()}
    with pytest.raises(pt.jit.GraphBreak):
        step(x, y)
    torch.cuda.synchronize()
    for p, v in zip(m.parameters(), params):
        assert torch.equal(p.detach(), v) and p.grad is None
    for k, v in opt._accumulators["moment1"].items():
        assert torch.equal(v, moments[k])
    assert opt._global_step == 1
    assert all(b == 1.0 for b in opt._accumulators["beta_pow"].values())

    m, opt, step, seen = build(False)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for _ in range(4):
            step(x, y)
    breaks = [x for x in w if "falling back to eager" in str(x.message)]
    em, eopt, estep, eseen = build(False, staged=False)
    for _ in range(4):
        estep(x, y)
    assert len(breaks) == 1 and seen == eseen
    for a, b in zip(m.parameters(), em.parameters()):
        assert torch.equal(a, b)
    assert step.stats()["eager_calls"] == 3


class _SyncInBackward(torch.autograd.Function):
    """The identity, whose backward reads its gradient on the host."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * (1.0 if float(g.sum()) >= 0 else 1.0)


@pytest.mark.cuda
def test_host_sync_in_the_backward_breaks_on_card():
    """A host sync that autograd's device thread meets inside the
    captured backward is caught by the same detector: a graph break with
    one warning, and the step runs eagerly with the eager step's
    results."""
    _need_cuda()
    import paddle_tpu_torch as pt
    x = torch.randn(8, 6, device="cuda")

    def build(staged):
        m = _sgd_mlp()
        opt = pt.SGD(0.1, parameters=m.parameters())

        def train_step(xb):
            loss = (_SyncInBackward.apply(m(xb)) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        return m, (pt.jit.to_static(train_step, capture=(m, opt))
                   if staged else train_step)

    m, step = build(True)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = [float(step(x)) for _ in range(3)]
    em, estep = build(False)
    want = [float(estep(x)) for _ in range(3)]
    assert len([x for x in w if "falling back" in str(x.message)]) == 1
    assert got == want
    for a, b in zip(m.parameters(), em.parameters()):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_dropout_masks_differ_between_replays_on_card():
    """A dropout drawing from an explicit CUDA generator inside a staged
    step: the generator is registered with the graph, so each replay
    draws a new mask (lr 0 keeps the weights, so only the mask moves the
    output)."""
    _need_cuda()
    import paddle_tpu_torch as pt
    gen = torch.Generator(device="cuda").manual_seed(7)
    m = pt.nn.Sequential(pt.nn.Linear(32, 32), pt.nn.Dropout(
        0.5, generator=gen)).cuda()
    with torch.no_grad():
        m[0].weight.normal_(0.0, 0.3)
        m[0].bias.fill_(1.0)
    m.train()
    opt = pt.SGD(0.0, parameters=m.parameters())

    def train_step(xb):
        out = m(xb)
        out.sum().backward()
        opt.step()
        opt.clear_grad()
        return out

    step = pt.jit.to_static(train_step, capture=(m, opt))
    x = torch.ones(16, 32, device="cuda")
    outs = [step(x) for _ in range(4)]       # warm-up, capture, replays
    masks = [(o == 0) for o in outs]
    assert step.stats()["replays"] == 3
    for a in range(4):
        assert 0.3 < float(masks[a].float().mean()) < 0.7
        for b in range(a + 1, 4):
            assert not torch.equal(masks[a], masks[b]), (a, b)


@pytest.mark.cuda
def test_staged_sgd_step_sees_the_decayed_lr_on_card():
    """``test_whole_step_with_lr_scheduler`` on the card: after the
    capture, each replay multiplies by the 0-d lr tensor the host rewrote
    from the scheduler (0.1, then 0.01 from the third step on), so the
    staged weights follow an eager twin's step for step (within f32
    rounding of the fused multiply), and the decayed steps are smaller."""
    _need_cuda()
    import paddle_tpu_torch as pt
    g = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn(16, 4, device="cuda", generator=g)
    y = torch.randn(16, 1, device="cuda", generator=g)
    w = 0.5 * torch.randn(4, 1, device="cuda", generator=g)

    def build(staged):
        m = pt.nn.Linear(4, 1).cuda()
        with torch.no_grad():
            m.weight.copy_(w)
            m.bias.zero_()
        sched = pt.optimizer.lr.StepDecay(0.1, step_size=2, gamma=0.1)
        opt = pt.SGD(learning_rate=sched, parameters=m.parameters())

        def train_step(xb, yb):
            loss = ((m(xb) - yb) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        step = pt.jit.to_static(train_step, capture=(m, opt)) if staged \
            else train_step
        return m, sched, step

    sm, ss, sstep = build(True)
    em, es, estep = build(False)
    moves = []
    for _ in range(5):
        before = sm.weight.detach().clone()
        sstep(x, y)
        estep(x, y)
        ss.step()
        es.step()
        torch.testing.assert_close(sm.weight, em.weight, rtol=1e-6,
                                   atol=1e-7)
        moves.append(float((sm.weight.detach() - before).abs().mean()))
    assert sstep.stats()["replays"] == 4
    assert max(moves[2:]) < 0.5 * min(moves[:2]), moves


@pytest.mark.cuda
def test_forward_staging_on_card():
    """``to_static(layer)``: in eval one forward graph whose replays equal
    the eager forward bit for bit; in training a forward and a backward
    graph on the tape (``make_graphed_callables``' pair), whose gradients
    and BatchNorm running statistics equal the eager layer's."""
    _need_cuda()
    import paddle_tpu_torch as pt

    def build():
        torch.manual_seed(8)
        m = pt.nn.Sequential(pt.nn.Linear(6, 16), pt.nn.BatchNorm1D(16),
                             pt.nn.ReLU(), pt.nn.Linear(16, 3)).cuda()
        with torch.no_grad():
            for p in m.parameters():
                p.normal_(0.0, 0.3)
        return m

    x = torch.randn(32, 6, device="cuda")
    eager, staged = build(), pt.jit.to_static(build())
    for mode in ("train", "eval"):
        getattr(eager, mode)()
        getattr(staged, mode)()
        for i in range(3):
            xi = x + i
            if mode == "train":
                for m in (eager, staged):
                    m.zero_grad(set_to_none=True)
                    (m(xi) ** 2).mean().backward()
                for a, b in zip(staged.parameters(), eager.parameters()):
                    torch.testing.assert_close(a.grad, b.grad, rtol=1e-5,
                                               atol=1e-6)
                for a, b in zip(staged.buffers(), eager.buffers()):
                    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
            else:
                with torch.no_grad():
                    assert torch.equal(staged(xi), eager(xi))
    st = staged.forward.stats()
    assert st["graphs"] == 2 and st["warmups"] == 2 and st["replays"] == 4
    # a second forward before the first one's backward overwrote the
    # graph's saved activations: that backward refuses to run
    staged.train()
    first = (staged(x) ** 2).mean()
    (staged(x + 1) ** 2).mean().backward()
    with pytest.raises(RuntimeError, match="ran again before the backward"):
        first.backward()


# ------------------------------------------ the zoo and the optimizers
_CARD_OPTS = [("Adagrad", (0.1,), {}),
              ("RMSProp", (0.01,), dict(momentum=0.9, centered=True)),
              ("Adadelta", (1.0,), {}), ("Adamax", (0.02,), {}),
              ("Lamb", (0.02,), {}), ("Rprop", (0.01,), {})]


def _opt_mlp(device, dtype=torch.float32, seed=3):
    import paddle_tpu_torch as pt
    g = torch.Generator().manual_seed(seed)
    m = pt.nn.Sequential(pt.nn.Linear(64, 48, device="cpu"), pt.nn.ReLU(),
                         pt.nn.Linear(48, 8, device="cpu"))
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=g))
    return m.to(device=device, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("master", [False, True], ids=["f32", "master"])
@pytest.mark.parametrize("cls,args,kw", _CARD_OPTS,
                         ids=[c for c, _, _ in _CARD_OPTS])
def test_other_optimizers_on_card_match_cpu(cls, args, kw, master):
    """Five steps of each multi-tensor optimizer on the card (its foreach
    ops on lists of 0-d step counts and scales too) against the same on
    the CPU, in f32 and in master mode (bf16 parameters, f32 masters):
    the f32 tensors within 1e-5 + 1e-5 |cpu|."""
    _need_cuda()
    import paddle_tpu_torch as pt
    dtype = torch.bfloat16 if master else torch.float32
    runs = []
    for dev in ("cpu", "cuda"):
        m = _opt_mlp(dev, dtype)
        opt = getattr(pt.optimizer, cls)(*args, parameters=m.parameters(),
                                         multi_precision=master, **kw)
        g = torch.Generator().manual_seed(4)
        for _ in range(5):
            for p in m.parameters():
                p.grad = torch.randn(p.shape, generator=g).to(dev, dtype)
            opt.step()
        runs.append([(opt._master_weights[p] if master else p)
                     .detach().float().cpu() for p in m.parameters()])
    for a, b in zip(*runs):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("cls,args,kw", _CARD_OPTS[:5],
                         ids=[c for c, _, _ in _CARD_OPTS[:5]])
def test_staged_other_optimizers_replay_equal_eager_on_card(cls, args, kw):
    """A staged MLP step with each optimizer under an ``ExponentialDecay``
    schedule: the replays (the lr from the 0-d tensor the host rewrites,
    Adamax's and Lamb's step counts advanced on the card) equal an eager
    twin bit for bit, with 0 graph breaks."""
    _need_cuda()
    import paddle_tpu_torch as pt
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(32, 64, device="cuda", generator=g)
    y = torch.randn(32, 8, device="cuda", generator=g)

    def build(staged):
        m = _opt_mlp("cuda")
        sched = pt.optimizer.lr.ExponentialDecay(args[0], gamma=0.7)
        opt = getattr(pt.optimizer, cls)(sched, parameters=m.parameters(),
                                         **kw)

        def train_step(xb, yb):
            loss = ((m(xb) - yb) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        step = pt.jit.to_static(train_step, capture=(m, opt),
                                full_graph=True) if staged else train_step
        return m, sched, step

    (sm, ss, sstep), (em, es, estep) = build(True), build(False)
    for _ in range(6):
        ls, le = sstep(x, y), estep(x, y)
        ss.step()
        es.step()
        assert torch.equal(ls, le.detach())
    for a, b in zip(sm.parameters(), em.parameters()):
        assert torch.equal(a, b)
    st = sstep.stats()
    assert st["graph_breaks"] == 0 and st["replays"] == 5


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw,side", [
    ("shufflenet_v2_x0_25", {}, 64), ("mobilenet_v3_small", {}, 64),
    ("squeezenet1_1", {}, 64), ("mobilenet_v2", dict(scale=0.5), 64),
    ("googlenet", {}, 64), ("inception_v3", {}, 75)])
def test_zoo_forward_on_card_matches_cpu(name, kw, side):
    """A zoo model's eval logits on the card (cuDNN, depthwise and
    grouped convolutions, concat, channel shuffle) against the port's CPU
    forward of the same weights, within 2e-3 + 2e-3 |cpu|."""
    _need_cuda()
    import paddle_tpu_torch as pt
    zoo = pt.vision.models
    torch.backends.cudnn.allow_tf32 = False
    model = getattr(zoo, name)(num_classes=10, seed=0, **kw).eval()
    cpu = getattr(zoo, name)(num_classes=10, device="cpu", seed=None, **kw)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu.eval()
    x = torch.randn(4, 3, side, side, generator=torch.Generator()
                    .manual_seed(6))
    with torch.no_grad():
        got = model(x.cuda()).cpu()
        want = cpu(x)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


def _token_set(n, S, vocab, seed):
    import paddle_tpu_torch as pt
    ids = np.random.RandomState(seed).randint(0, vocab, (n, S))
    y = (ids[:, 0] < vocab // 2).astype(np.int64)

    class Tokens(pt.io.Dataset):
        def __getitem__(self, i):
            return ids[i], y[i]

        def __len__(self):
            return n

    return Tokens()


@pytest.mark.cuda
def test_hapi_fit_equals_a_hand_loop_on_card():
    """``Model.fit`` of ``BertForSequenceClassification(bert_tiny())`` at
    S 64 (O1 bf16, ``AdamW`` under ``LinearWarmup`` stepped by the
    ``LRScheduler`` callback, batches from two worker processes) gives
    a hand-written ``to_static`` loop's losses over the same batches from
    the same weights (within 1e-3), with one capture, no break, and
    exact launches: the flash trio once a layer, LayerNorm 2L + 1 and
    AdamW once a replayed step; flash forward L and LayerNorm 2L + 1 an
    evaluate batch."""
    _need_cuda()
    import paddle_tpu_torch as pt
    cfg = pt.bert_tiny(dropout=0.0)
    L, B, S, steps = cfg.num_layers, 8, 64, 6
    data = _token_set(B * steps, S, cfg.vocab_size, 3)

    def build():
        net = pt.BertForSequenceClassification(cfg, seed=4)
        lr = pt.optimizer.lr
        sched = lr.LinearWarmup(1e-3, 2, 0.0, 1e-3)
        return net, sched, pt.AdamW(sched, parameters=net.parameters(),
                                    weight_decay=0.01)

    net, sched, opt = build()
    model = pt.Model(net)
    model.prepare(opt, pt.nn.CrossEntropyLoss(), pt.metric.Accuracy(),
                  amp_configs="O1")
    seen = {"losses": [], "counts": None}

    class Rec(pt.hapi.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            seen["losses"].append(logs["loss"])
            if seen["counts"] is None:
                seen["counts"] = K.launch_counts()

    loader = pt.io.DataLoader(data, batch_size=B, num_workers=2, timeout=60)
    model.fit(loader, epochs=1, verbose=0,
              callbacks=[Rec(), pt.hapi.callbacks.LRScheduler()])
    after = K.launch_counts()
    replayed = {k: after[k] - seen["counts"][k] for k in after}
    want = {k: 0 for k in after}
    n = steps - 1
    want.update({"flash_fwd": n * L, "flash_bwd_dq": n * L,
                 "flash_bwd_dkv": n * L, "layer_norm": n * (2 * L + 1),
                 "fused_adamw": n})
    assert replayed == want
    st = model._step_fn.stats()
    assert st["graphs"] == 1 and st["graph_breaks"] == 0
    before = K.launch_counts()
    model.evaluate(_token_set(2 * B, S, cfg.vocab_size, 5), batch_size=B)
    after = K.launch_counts()
    assert after["flash_fwd"] - before["flash_fwd"] == 2 * L
    assert after["layer_norm"] - before["layer_norm"] == 2 * (2 * L + 1)
    net, sched, opt = build()

    def train_step(x, y):
        with pt.auto_cast(level="O1", dtype="bfloat16"):
            loss = pt.nn.functional.cross_entropy(net(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    step = pt.jit.to_static(train_step, capture=(net, opt))
    hand = []
    for x, y in pt.io.DataLoader(data, batch_size=B):
        hand.append(float(step(x, y)))
        sched.step()
    assert len(hand) == steps
    np.testing.assert_allclose(seen["losses"], hand, rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("workers", [0, 2])
def test_dataloader_places_batches_on_card(workers):
    """Batches land on the card by default (through pinned memory); a
    TensorDataset of card tensors is snapshotted to the host before the
    workers fork, so the workers never touch CUDA."""
    _need_cuda()
    import paddle_tpu_torch as pt
    xs = torch.arange(24, dtype=torch.float32, device="cuda").reshape(12, 2)
    ys = torch.arange(12, device="cuda")
    loader = pt.io.DataLoader(pt.io.TensorDataset([xs, ys]), batch_size=5,
                              num_workers=workers, timeout=60)
    got = list(loader)
    assert [tuple(x.shape) for x, _ in got] == [(5, 2), (5, 2), (2, 2)]
    assert all(x.device.type == "cuda" and y.device.type == "cuda"
               for x, y in got)
    assert torch.equal(torch.cat([x for x, _ in got]), xs)
    assert torch.equal(torch.cat([y for _, y in got]), ys)


@pytest.mark.cuda
def test_save_load_bf16_round_trip_on_card(tmp_path):
    _need_cuda()
    import paddle_tpu_torch as pt
    w = torch.randn(3, 5, device="cuda").bfloat16()
    pt.save({"w": w, "n": [torch.ones(2, device="cuda")]},
            str(tmp_path / "x.pdparams"))
    got = pt.load(str(tmp_path / "x.pdparams"))
    assert got["w"].device.type == "cuda" and got["w"].dtype == w.dtype
    assert torch.equal(got["w"], w)
    assert torch.equal(got["n"][0], torch.ones(2, device="cuda"))


# ---------------------------------------------------- the op surface
def _surface_card_cases():
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_surface_cases as C
    want = {"unary": ("exp", "log", "tanh", "erfinv", "lgamma", "round"),
            "binary": ("add", "divide", "pow", "atan2", "remainder",
                       "bitwise_right_shift"),
            "reduce": ("sum", "median", "var", "cummax", "logsumexp",
                       "quantile"),
            "creation": ("arange", "linspace", "eye", "diag", "to_tensor"),
            "logic": ("equal", "isclose", "allclose", "logical_xor"),
            "search": ("sort", "argsort", "topk", "mode", "nonzero"),
            "manip": ("split", "gather_nd", "scatter", "take_along_axis",
                      "put_along_axis", "unique", "masked_select",
                      "histogramdd"),
            "linalg": ("matmul", "svd", "qr", "cholesky", "solve", "lstsq",
                       "eigh", "linalg.lu_unpack")}
    return C, [c for fam, names in want.items()
               for c in C.ALL_TABLES[fam] if c.op in names]


@pytest.mark.cuda
def test_surface_sweep_on_card_matches_cpu():
    """A handful of each family's parity cases on the card against the same
    port call on CPU tensors (the tolerances of
    ``tests/torch_surface_cases.py``; decompositions by invariants)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke as cs
    import paddle_tpu_torch as pt
    C, cases = _surface_card_cases()
    try:
        worst, n_ops, n_cases = cs.surface_sweep(pt, cases)
    finally:
        pt.set_device("gpu")
    assert n_cases == len(cases) and n_ops >= 40
    assert worst["int"] == 0.0 and worst["f32"] <= 1e-4


@pytest.mark.cuda
def test_top_p_sampling_on_card():
    """Nucleus sampling on CUDA: ids inside the row's nucleus, int64 on the
    card, repeatable under ``seed``, the first token always kept."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import paddle_tpu_torch as pt
    probs = torch.softmax(torch.randn(8, 1000, device="cuda") * 4, -1)
    ps = torch.full((8,), 0.8, device="cuda")
    pt.seed(5)
    s1, i1 = pt.top_p_sampling(probs, ps)
    pt.seed(5)
    s2, i2 = pt.top_p_sampling(probs, ps)
    assert torch.equal(i1, i2) and i1.device.type == "cuda"
    assert i1.dtype == torch.int64 and list(i1.shape) == [8, 1]
    sp, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    keep = (torch.cumsum(sp, -1) - sp) < 0.8
    for r in range(8):
        assert int(i1[r]) in set(order[r][keep[r]].tolist())
    tiny = torch.full((8,), 1e-9, device="cuda")
    assert torch.equal(pt.top_p_sampling(probs, tiny)[1][:, 0], order[:, 0])


@pytest.mark.cuda
def test_to_static_step_with_nonzero_graph_breaks_on_card():
    """A staged step that calls ``pt.nonzero`` (a data-dependent shape)
    graph-breaks and runs eagerly, with the eager values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import paddle_tpu_torch as pt
    w = torch.nn.Parameter(torch.randn(4, 4, device="cuda"))
    opt = pt.SGD(learning_rate=0.1, parameters=[w])

    def step(x):
        y = pt.matmul(x, w)
        n = pt.nonzero(y > 0).shape[0]
        loss = pt.mean(y * y) + 0.0 * n
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    staged = pt.jit.to_static(step, capture=(opt,))
    x = torch.randn(3, 4, device="cuda")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        losses = [float(staged(x)) for _ in range(3)]
    assert staged.stats()["graph_breaks"] >= 1
    assert staged.stats()["graphs"] == 0
    assert losses[2] < losses[0]


@pytest.mark.cuda
def test_to_static_step_with_scalar_operands_stages_on_card():
    """A train step written against the surface with Python-number
    operands (``multiply(h, 0.5)``, ``add``, ``clip``, ``where``,
    ``masked_fill``, ``scale``) stages as one CUDA graph with no graph
    break, and its losses equal the eager step's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import paddle_tpu_torch as pt
    init = torch.randn(4, 4, device="cuda")

    def make():
        w = torch.nn.Parameter(init.clone())
        opt = pt.SGD(learning_rate=0.1, parameters=[w])

        def step(x):
            h = pt.multiply(pt.matmul(x, w), 0.5)
            h = pt.clip(pt.add(h, 1.0), 0.0, 6.0)
            h = pt.where(h > 3.0, h, 0.0)
            h = pt.masked_fill(h, h > 5.0, -1.0)
            loss = pt.mean(pt.scale(h * h, 2.0, 0.5))
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        return step, opt

    x = torch.randn(8, 4, device="cuda") * 3
    step, _ = make()
    eager = [float(step(x)) for _ in range(4)]
    step, opt = make()
    staged = pt.jit.to_static(step, capture=(opt,))
    got = [float(staged(x)) for _ in range(4)]
    assert staged.stats()["graph_breaks"] == 0
    assert staged.stats()["graphs"] == 1
    np.testing.assert_allclose(got, eager, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_to_static_draws_fresh_random_numbers_each_replay_on_card():
    """A staged function that calls ``pt.rand`` draws from the framework
    generator, which the capture registers with the graph: every replay
    draws anew, and ``pt.seed`` makes the replays repeat."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import paddle_tpu_torch as pt

    def draw(x):
        return pt.add(x, pt.rand([64]))

    staged = pt.jit.to_static(draw)
    x = torch.zeros(64, device="cuda")
    with torch.no_grad():
        staged(x)
        staged(x)
        pt.seed(11)
        a = [staged(x) for _ in range(3)]
        pt.seed(11)
        b = [staged(x) for _ in range(3)]
    assert staged.stats()["graphs"] == 1
    assert staged.stats()["graph_breaks"] == 0
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[1], a[2])
    for u, v in zip(a, b):
        assert torch.equal(u, v)


# ------------------------------------- nn.Layer, initializers, ParamAttr
@pytest.mark.cuda
def test_layers_initialise_on_the_card_by_default():
    """A layer built with no device lands on the card with the JAX
    layers' defaults: ``Linear``'s XavierUniform weight and zero bias,
    ``Embedding``'s zero padding row, ``LayerNorm``'s ones and zeros;
    ``LayerNorm`` over two trailing axes launches the Triton kernel and
    equals its plain version on the CPU."""
    _need_cuda()
    import paddle_tpu_torch as pt
    pt.seed(1)
    lin = pt.nn.Linear(4, 8)
    assert lin.weight.device.type == "cuda" and lin.bias.device.type == "cuda"
    w = lin.weight.detach().cpu()
    assert float(w.abs().max()) <= math.sqrt(6 / 12) and float(w.std()) > 0.2
    assert float(lin.bias.abs().max()) == 0.0
    emb = pt.nn.Embedding(10, 6, padding_idx=3)
    assert float(emb.weight[3].abs().max()) == 0.0
    ln = pt.nn.LayerNorm([4, 8])
    with torch.no_grad():
        ln.weight.normal_()
        ln.bias.normal_()
    x = torch.randn(5, 4, 8, device="cuda")
    before = K.layer_norm.launches
    out = ln(x)
    torch.cuda.synchronize()
    assert K.layer_norm.launches == before + 1
    ref = K.layer_norm_reference(x.cpu().reshape(5, 32),
                                 ln.weight.detach().cpu().reshape(32),
                                 ln.bias.detach().cpu().reshape(32))
    torch.testing.assert_close(out.cpu(), ref.reshape(5, 4, 8), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.cuda
def test_staged_per_parameter_rates_on_card_equal_eager():
    """A model with a weight at 10x the rate, a frozen bias and a weight
    at half the rate, staged through ``to_static`` with AdamW and a global
    clip: 1 graph, 0 breaks, one fused AdamW launch a replay; the frozen
    bias bit-unchanged; the weights within 1e-6 of the same steps run
    eagerly (the kernel's per-tensor rate carries each scale)."""
    _need_cuda()
    import paddle_tpu_torch as pt

    def build():
        pt.seed(4)
        m = pt.nn.Sequential(
            pt.nn.Linear(32, 64, weight_attr=pt.ParamAttr(learning_rate=10.),
                         bias_attr=pt.ParamAttr(trainable=False)),
            pt.nn.Tanh(),
            pt.nn.Linear(64, 8, weight_attr=pt.ParamAttr(learning_rate=0.5),
                         bias_attr=pt.ParamAttr(need_clip=False)))
        opt = pt.AdamW(1e-3, parameters=m.parameters(), weight_decay=0.01,
                       grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))

        def step(x, y):
            loss = ((m(x) - y) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        return m, opt, step

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(16, 32, device="cuda", generator=g)
    y = torch.randn(16, 8, device="cuda", generator=g)
    runs = []
    for staged in (False, True):
        m, opt, step = build()
        frozen = m[0].bias.detach().clone()
        fn = pt.jit.to_static(step, capture=(m, opt)) if staged else step
        for _ in range(2):
            float(fn(x, y))
        K.reset_launch_counts()
        losses = [float(fn(x, y)) for _ in range(5)]
        launches = K.launch_counts()["fused_adamw"]
        assert torch.equal(m[0].bias.detach(), frozen)
        runs.append((losses, [p.detach().clone() for p in m.parameters()],
                     launches, fn))
    (el, ew, _, _), (sl, sw, sn, fn) = runs
    st = fn.stats()
    assert st["graphs"] == 1 and st["graph_breaks"] == 0 and sn == 5
    np.testing.assert_allclose(sl, el, rtol=1e-6, atol=1e-7)
    for a, b in zip(sw, ew):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


# ------------------------------------- the rest of nn (Conformer slice)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,affine", [
    ("bfloat16", [256], True), ("float32", [256], False),
    ("float32", [4, 64], True)])
def test_functional_layer_norm_launches_the_kernel_on_card(dtype, shape,
                                                           affine):
    """``F.layer_norm`` on a CUDA tensor launches the LayerNorm kernel
    once (over the flattened trailing axes) and matches its plain version
    (f32: atol 1e-4; bf16: rtol/atol 2e-2)."""
    _need_cuda()
    from paddle_tpu_torch.nn import functional as PF
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(7)
    x = (torch.randn(16 * 255, *shape, device="cuda", generator=g) * 2
         + 1).to(dt)
    w = (1 + 0.1 * torch.randn(*shape, device="cuda", generator=g)).to(dt) \
        if affine else None
    b = (0.1 * torch.randn(*shape, device="cuda", generator=g)).to(dt) \
        if affine else None
    before = K.layer_norm.launches
    got = PF.layer_norm(x, shape, w, b)
    torch.cuda.synchronize()
    assert K.layer_norm.launches == before + 1
    n = math.prod(shape)
    want = K.layer_norm_reference(
        x.reshape(-1, n), None if w is None else w.reshape(n),
        None if b is None else b.reshape(n)).reshape(x.shape)
    tol = 1e-4 if dt == torch.float32 else 2e-2
    assert got.dtype == dt
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_trio_at_t255_d64_matches_plain_on_card():
    """The Conformer-M attention shape, [16, 255, 4, 64] bf16 non-causal
    (255 is no multiple of the 64/128 tiles): forward, dQ, dK and dV of
    the kernels, one launch each, against autograd through the plain
    chain in f32 on the same values (rtol/atol 2e-2 elementwise and 1e-2
    on the error's norm)."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = (torch.randn(16, 255, 4, 64, device="cuda", generator=g)
               .bfloat16().requires_grad_(True) for _ in range(3))
    ct = torch.randn(16, 255, 4, 64, device="cuda", generator=g).bfloat16()
    before = K.launch_counts()
    out = K.flash_attention_bshd(q, k, v, causal=False)
    got = torch.autograd.grad((out.float() * ct.float()).sum(), (q, k, v))
    torch.cuda.synchronize()
    after = K.launch_counts()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert after[name] == before[name] + 1, name
    ref = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    sc = torch.einsum("bqhd,bkhd->bhqk", ref[0], ref[1]) / 8.0
    o = torch.einsum("bhqk,bkhd->bqhd", sc.softmax(-1), ref[2])
    want = torch.autograd.grad((o * ct.float()).sum(), ref)
    for name, a, b in zip(("out", "dq", "dk", "dv"), (out,) + got,
                          (o,) + want):
        torch.testing.assert_close(a.float(), b.detach(), rtol=2e-2,
                                   atol=2e-2, msg=name)
        err = float((a.float() - b.detach()).norm() / b.detach().norm())
        assert err <= 1e-2, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [13, 14, 15, 16])
def test_rnnt_and_ctc_losses_on_card_match_cpu(seed):
    """``rnnt_loss`` at [2, T 255, U + 1 = 65, V 32] and ``ctc_loss`` at
    [T 255, 2, 32] on the card against the same calls on the CPU: losses
    within rtol 1e-5; the scores' gradients (entries up to ~0.5) within
    rtol / atol 1e-5. Both losses carry their lattices (sums to |ll| ~
    900) in f64, so the order each device's scans sum in does not show;
    what differs is the f32 log-softmax, a few ulps. Each case prints its
    loss and gradient errors."""
    _need_cuda()
    from paddle_tpu_torch.nn import functional as PF
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 255, 65, 32).astype(np.float32)
    y = rng.randn(255, 2, 32).astype(np.float32)
    lab = torch.from_numpy(rng.randint(1, 32, (2, 64)))
    in_len, lab_len = torch.tensor([255, 201]), torch.tensor([64, 40])
    for fn, arr in ((PF.rnnt_loss, x), (PF.ctc_loss, y)):
        outs = []
        for dev in ("cpu", "cuda"):
            t = torch.from_numpy(arr).to(dev).requires_grad_(True)
            loss = fn(t, lab.to(dev), in_len.to(dev), lab_len.to(dev))
            (grad,) = torch.autograd.grad(loss, t)
            outs.append((float(loss.detach()), grad.cpu()))
        (l_c, g_c), (l_d, g_d) = outs
        g_err = float((g_d - g_c).abs().max())
        msg = (f"seed {seed} {fn.__name__}: loss {l_d!r} on the card vs "
               f"{l_c!r}, gradient max abs err {g_err:.3e}")
        print(msg)
        assert l_d == pytest.approx(l_c, rel=1e-5), msg
        torch.testing.assert_close(g_d, g_c, rtol=1e-5, atol=1e-5, msg=msg)


@pytest.mark.cuda
def test_nn_sweep_on_card_matches_cpu():
    """Every case of ``tests/torch_nn_cases.py`` on the card against the
    CPU: outputs on the card, dtypes and shapes equal, values and every
    gradient within the table's f32 tolerance (TF32 off)."""
    _need_cuda()
    import os
    import sys
    import paddle_tpu_torch as pt
    sys.path.insert(0, os.path.dirname(__file__))
    import torch_nn_cases as C
    tf32 = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for case in C.CASES:
            cpu, cpu_g, _ = C.run(pt, case, "cpu")
            dev, dev_g, where = C.run(pt, case, "cuda")
            assert set(where) == {"cuda"}, case[0]
            for a, b in zip(cpu + cpu_g, dev + dev_g):
                assert (a is None) == (b is None), case[0]
                if a is None:
                    continue
                assert a.dtype == b.dtype and a.shape == b.shape, case[0]
                torch.testing.assert_close(b, a, rtol=C.RTOL, atol=C.ATOL,
                                           msg=case[0])
    finally:
        pt.set_device("cuda")
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32


@pytest.mark.cuda
def test_resize_pad_and_sparse_attention_stage_on_card():
    """``Upsample`` (bilinear and nearest), ``Pad2D`` in its reflect,
    replicate and circular modes and ``sparse_attention`` over a CSR
    pattern on the card make their indices, resize weights and mask on the
    device: a train step through them stages with ``to_static`` as 1 graph
    with 0 breaks, and its losses equal the eager step's (rtol 1e-5)."""
    _need_cuda()
    import paddle_tpu_torch as pt
    S = 12
    cols = [list(range(max(0, r - 2), r + 1)) + ([S - 1] if r < S - 1
                                                 else []) for r in range(S)]
    off = torch.tensor(np.cumsum([0] + [len(c) for c in cols]),
                       dtype=torch.int32, device="cuda").reshape(1, 1, -1)
    col = torch.tensor([c for cs in cols for c in cs], dtype=torch.int32,
                       device="cuda").reshape(1, 1, -1)

    def build():
        pt.seed(3)
        conv = pt.nn.Conv2D(3, 4, 3)
        layers = pt.nn.Sequential(
            conv, pt.nn.Upsample(scale_factor=2, mode="bilinear"),
            pt.nn.Upsample(size=[10, 16]),
            pt.nn.Pad2D([1, 2, 1, 0], mode="reflect"),
            pt.nn.Pad2D([0, 1, 0, 1], mode="replicate"),
            pt.nn.Pad2D([1, 1, 0, 0], mode="circular"))
        opt = pt.SGD(learning_rate=0.05, parameters=conv.parameters())

        def step(x):
            h = layers(x)                                  # [2, 4, 12, 22]
            out = pt.nn.functional.sparse_attention(h, h, h, off, col)
            loss = (out * out).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        return conv, opt, step

    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(2, 3, 8, 8, device="cuda", generator=g)
    runs = []
    for staged in (False, True):
        conv, opt, step = build()
        fn = pt.jit.to_static(step, capture=(conv, opt)) if staged else step
        runs.append(([float(fn(x)) for _ in range(5)], fn))
    (eager, _), (got, fn) = runs
    st = fn.stats()
    assert st["graphs"] == 1 and st["graph_breaks"] == 0, st
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, eager, rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
def test_sequence_mask_of_a_list_lands_on_the_card():
    """A list of lengths goes to the current device, as every entry point's
    input does: ``sequence_mask([3, 5])`` returns a card tensor."""
    _need_cuda()
    from paddle_tpu_torch.nn import functional as PF
    got = PF.sequence_mask([3, 5])
    assert got.device.type == "cuda"
    assert got.cpu().tolist() == [[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]]


@pytest.mark.cuda
def test_incubate_sweep_on_card_matches_cpu():
    """Every case of ``tests/torch_incubate_cases.py`` (the incubate
    functions and the ``incubate.nn`` layers) on the card against the CPU:
    outputs on the card, dtypes and shapes equal, values and every
    gradient within the table's f32 tolerance (TF32 off)."""
    _need_cuda()
    import os
    import sys
    import paddle_tpu_torch as pt
    sys.path.insert(0, os.path.dirname(__file__))
    import torch_incubate_cases as C
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for case in C.CASES:
            cpu, cpu_g, _ = C.run(pt, case, "cpu")
            dev, dev_g, where = C.run(pt, case, "cuda")
            assert set(where) == {"cuda"}, case[0]
            for a, b in zip(cpu + cpu_g, dev + dev_g):
                assert (a is None) == (b is None), case[0]
                if a is None:
                    continue
                assert a.dtype == b.dtype and a.shape == b.shape, case[0]
                torch.testing.assert_close(b, a, rtol=C.RTOL, atol=C.ATOL,
                                           msg=case[0])
    finally:
        pt.set_device("cuda")
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.cuda
def test_pylayer_and_custom_op_stage_as_one_graph_on_card():
    """A train step through a user ``PyLayer`` (GELU, tanh form, with its
    own backward) and a ``custom_op`` with a user ``vjp`` stages with
    ``to_static`` as 1 graph with 0 breaks, on the RMSNorm kernel, and
    its losses equal the eager step's (rtol 1e-5)."""
    _need_cuda()
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.utils import cpp_extension as cpp

    class Gelu(pt.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return torch.nn.functional.gelu(x, approximate="tanh")

        @staticmethod
        def backward(ctx, dy):
            x, = ctx.saved_tensor()
            with torch.enable_grad():
                z = x.detach().requires_grad_(True)
                g, = torch.autograd.grad(torch.nn.functional.gelu(
                    z, approximate="tanh"), z, dy)
            return g

    sq = cpp._REGISTRY.get("card_scaled_sq") or cpp.custom_op(
        name="card_scaled_sq", vjp=lambda ct, x, out=None: 2 * x * ct)(
            lambda x: x * x)

    def build():
        pt.seed(4)
        lin = pt.nn.Linear(64, 64)
        w = pt.create_parameter([64], "float32", default_initializer=pt.nn
                                .initializer.Constant(1.0))
        opt = pt.AdamW(1e-2, parameters=lin.parameters() + [w])

        def step(x):
            h = pt.incubate.fused_rms_norm(Gelu.apply(lin(x)), w)
            loss = sq(h).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        return (lin, w, opt), step

    x = torch.randn(16, 64, device="cuda")
    runs = []
    for staged in (False, True):
        (lin, w, opt), step = build()
        holder = pt.nn.Layer()
        holder.lin, holder.w = lin, w
        fn = pt.jit.to_static(step, capture=(holder, opt), full_graph=True) \
            if staged else step
        K.reset_launch_counts()
        runs.append(([float(fn(x)) for _ in range(5)], fn,
                     K.launch_counts()["rms_norm"]))
    (eager, _, n_eager), (got, fn, _) = runs
    st = fn.stats()
    assert st["graphs"] == 1 and st["graph_breaks"] == 0, st
    assert n_eager == 5 and got[-1] < got[0]
    np.testing.assert_allclose(got, eager, rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
def test_flash_flag_refuses_attention_on_card():
    """``FLAGS_use_flash_attention=False`` makes eligible attention on a
    CUDA tensor raise (the port keeps no plain version on the card's
    path); a masked call, which never took the kernels, runs."""
    _need_cuda()
    import paddle_tpu_torch as pt
    q = torch.randn(2, 32, 2, 64, device="cuda", dtype=torch.bfloat16)
    pt.set_flags({"FLAGS_use_flash_attention": False})
    try:
        with pytest.raises(RuntimeError, match="FLAGS_use_flash_attention"):
            pt.incubate.flash_attention(q, q, q, causal=True)
        with pytest.raises(RuntimeError, match="FLAGS_use_flash_attention"):
            pt.nn.functional.scaled_dot_product_attention(q, q, q)
        mask = torch.zeros(2, 1, 32, 32, device="cuda", dtype=torch.bfloat16)
        out = pt.nn.functional.scaled_dot_product_attention(
            q, q, q, attn_mask=mask)
        assert out.shape == q.shape
    finally:
        pt.set_flags({"FLAGS_use_flash_attention": True})
    before = K.flash_fwd.launches
    pt.incubate.flash_attention(q, q, q, causal=True)
    assert K.flash_fwd.launches == before + 1


@pytest.mark.cuda
def test_stream_guard_and_wait_stream_order_work_on_card():
    """Work queued under ``stream_guard(side)`` runs on the side stream
    (queued behind a sleep there), and the default stream's
    ``wait_stream(side)`` orders a read after it: the read sees the
    side stream's writes. An ``Event`` recorded after them is done after
    ``synchronize``."""
    _need_cuda()
    import paddle_tpu_torch as pt
    D = pt.device
    side = D.Stream()
    assert side.cuda_stream is not None
    x = torch.zeros(1 << 20, device="cuda")
    side.wait_stream(D.current_stream())
    with D.stream_guard(side):
        assert torch.cuda.current_stream() == side.cuda_stream
        torch.cuda._sleep(50_000_000)
        x.fill_(3.0)
    D.current_stream().wait_stream(side)
    total = x.sum()
    ev = D.Event()
    ev.record(D.current_stream())
    D.synchronize()
    assert ev.query() and float(total) == 3.0 * x.numel()
    assert D.current_stream().cuda_stream == torch.cuda.current_stream()


@pytest.mark.cuda
def test_memory_stats_keys_and_counters_on_card():
    """``memory_stats`` holds the JAX key names filled from torch's
    allocator; the counters equal torch's."""
    _need_cuda()
    import paddle_tpu_torch as pt
    D = pt.device
    torch.cuda.synchronize()
    keep = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    s = D.memory_stats()
    assert {"bytes_in_use", "peak_bytes_in_use", "bytes_reserved",
            "bytes_limit"} <= set(s)
    assert s["bytes_limit"] == torch.cuda.get_device_properties(0) \
        .total_memory
    assert D.memory_allocated() == torch.cuda.memory_allocated()
    assert D.max_memory_allocated() == torch.cuda.max_memory_allocated()
    assert D.memory_reserved() == torch.cuda.memory_reserved()
    assert D.max_memory_reserved() == torch.cuda.max_memory_reserved()
    assert D.cuda.memory_allocated() >= keep.numel()
    assert D.cuda.get_device_properties()["platform"] == "gpu"
    assert D.get_all_devices()[0] == torch.device("cuda", 0)
    del keep


@pytest.mark.cuda
def test_tensor_checker_raises_on_card_and_stays_silent_in_capture():
    """The checker raises at an eager op that makes an Inf on the card;
    inside a CUDA graph capture it reads nothing back (the capture would
    fail on a read), so the graph captures and its replay makes the Inf
    unchecked, as a staged JAX program is."""
    _need_cuda()
    from paddle_tpu_torch.amp import debugging as dbg
    from paddle_tpu_torch.core import op_hook
    x = torch.full((8,), -1.0, device="cuda")
    out = torch.empty(8, device="cuda")
    dbg.enable_tensor_checker(dbg.TensorCheckerConfig())
    try:
        with pytest.raises(FloatingPointError, match="'log'"):
            torch.log(x)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            with torch.cuda.graph(graph, stream=side):
                out.copy_(torch.log(x))
        torch.cuda.current_stream().wait_stream(side)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.isnan(out).all()
    finally:
        dbg.disable_tensor_checker()
    assert not op_hook.installed()


# ------------------------------------------- exported programs (slice 19)
def _tiny_bert(pt, device):
    model = pt.BertForSequenceClassification(pt.bert_tiny(), device=device,
                                             seed=0)
    model.eval()
    return model


@pytest.mark.cuda
def test_cpu_exported_program_launches_kernels_on_card(tmp_path):
    """A program exported on the CPU holds the ``flash_fwd`` and
    ``layer_norm`` ops; loaded on the card it launches kernels 1 and 8 (2
    and 5 a call for ``bert_tiny``) and gives the CPU model's logits."""
    _need_cuda()
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import device as port_device
    before = port_device.DEFAULT_DEVICE
    port_device.DEFAULT_DEVICE = "cpu"
    try:
        model = _tiny_bert(pt, "cpu")
        pt.jit.save(model, str(tmp_path / "b"),
                    input_spec=[pt.jit.InputSpec([None, 16], "int64")])
    finally:
        port_device.DEFAULT_DEVICE = before
    layer = pt.jit.load(str(tmp_path / "b"), device="cuda")
    ids = np.random.RandomState(0).randint(0, 1024, (3, 16))
    for _ in range(3):
        K.reset_launch_counts()
        got = layer(ids)
        torch.cuda.synchronize()
        assert {k: v for k, v in K.launch_counts().items() if v} == {
            "flash_fwd": 2, "layer_norm": 5}
    with torch.no_grad():
        want = model(torch.from_numpy(ids))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_translated_layer_captures_a_graph_per_shape_on_card(tmp_path):
    """On the card a loaded program runs as one CUDA graph per input
    shape (the shape's first call warms up, its second captures), and a
    returned output is a copy that the next replay leaves alone."""
    _need_cuda()
    import paddle_tpu_torch as pt
    model = _tiny_bert(pt, "cuda")
    pt.jit.save(model, str(tmp_path / "b"),
                input_spec=[pt.jit.InputSpec([None, 16], "int64")])
    layer = pt.jit.load(str(tmp_path / "b"))
    rng = np.random.RandomState(1)
    a, b = (torch.from_numpy(rng.randint(0, 1024, (4, 16))).cuda()
            for _ in range(2))
    for n in (2, 4):
        for _ in range(3):
            layer(a[:n])
    st = layer.stats()
    assert st["graphs"] == 2 and st["warmups"] == 2 and st["replays"] == 4
    first = layer(a)
    kept = first.clone()
    second = layer(b)
    torch.cuda.synchronize()
    assert torch.equal(first, kept) and not torch.equal(first, second)
    with torch.no_grad():
        torch.testing.assert_close(first, model(a), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_staged_cond_step_is_one_graph_on_card():
    """A Python ``if`` on a device tensor inside a staged train step runs
    both branches and selects on the card: one graph, no break, and each
    replay follows the flag's value."""
    _need_cuda()
    import paddle_tpu_torch as pt
    torch.manual_seed(0)
    lin = pt.nn.Linear(16, 16, device="cuda")
    opt = pt.SGD(learning_rate=0.0, parameters=lin.parameters())

    def step(x, w):
        loss = lin(x).square().mean()
        if w > 0:
            loss = loss + w * lin(x).abs().mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    staged = pt.jit.to_static(step, capture=(lin, opt), full_graph=True)
    x = torch.randn(8, 16, device="cuda")
    for v in (1.0, -1.0, 0.5, -2.0, 2.0):
        w = torch.tensor(v, device="cuda")
        got = staged(x, w)
        with torch.no_grad():
            want = lin(x).square().mean() + (
                v * lin(x).abs().mean() if v > 0 else 0.0)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    st = staged.stats()
    assert st["graphs"] == 1 and st["graph_breaks"] == 0 \
        and st["replays"] == 4


@pytest.mark.cuda
def test_staged_if_with_effects_runs_only_the_taken_branch_on_card():
    """A Python ``if`` on a device tensor whose branch calls
    ``opt.step()`` cannot be selected after both branches ran: the
    warm-up call reads the predicate as Python does, the capture breaks
    the graph, and every call steps only when the flag holds."""
    _need_cuda()
    import paddle_tpu_torch as pt
    torch.manual_seed(0)
    lin = pt.nn.Linear(16, 16, device="cuda")
    opt = pt.SGD(learning_rate=0.1, parameters=lin.parameters())

    def step(x, w):
        loss = lin(x).square().mean()
        loss.backward()
        if w > 0:
            opt.step()
        opt.clear_grad()
        return loss

    staged = pt.jit.to_static(step, capture=(lin, opt))
    x = torch.randn(8, 16, device="cuda")
    w0 = lin.weight.detach().clone()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(3):
            staged(x, torch.tensor(-1.0, device="cuda"))
        assert torch.equal(lin.weight, w0)
        staged(x, torch.tensor(1.0, device="cuda"))
    assert not torch.equal(lin.weight, w0)
    st = staged.stats()
    assert st["warmups"] == 1 and st["graph_breaks"] == 1 \
        and st["graphs"] == 0


@pytest.mark.cuda
def test_batching_predictor_returns_every_row_on_card(tmp_path):
    """Concurrent single-example callers through ``BatchingPredictor``
    over a dynamic-batch export on the card: every caller gets its own
    row, and each bucket is one captured graph."""
    _need_cuda()
    import threading
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.inference import (BatchingPredictor, Config,
                                            Predictor)
    model = _tiny_bert(pt, "cuda")
    path = str(tmp_path / "b")
    pt.jit.save(model, path,
                input_spec=[pt.jit.InputSpec([None, 16], "int64")])
    pred = Predictor(Config(path))
    ids = np.random.RandomState(2).randint(0, 1024, (48, 16))
    res = [None] * len(ids)

    def client(c):
        for i in range(c, len(ids), 8):
            res[i] = bp.predict(ids[i])

    with BatchingPredictor(pred, max_batch_size=8, max_wait_ms=2.0,
                           batch_buckets=[1, 2, 4, 8]) as bp:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    with torch.no_grad():
        want = model(torch.from_numpy(ids).cuda()).cpu().numpy()
    np.testing.assert_allclose(np.stack(res), want, rtol=1e-4, atol=1e-4)
    assert pred._layer.stats()["graph_breaks"] == 0


@pytest.mark.cuda
def test_snapshot_with_fused_adamw_state_round_trips_on_card(tmp_path):
    """A CUDA model's parameters and fused-AdamW state (O2: f32 masters
    and bf16 moments) through ``CheckpointLineage`` (an async save: pinned
    buffers on a side stream) back onto the card: bit-equal, copied into
    the same storage, and a step after the load equals a step after the
    save."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed.fault import CheckpointLineage

    def build():
        net = pt.BertForSequenceClassification(pt.bert_tiny(), num_classes=2,
                                               seed=3)
        opt = pt.AdamW(1e-3, parameters=net.parameters(),
                       multi_precision=True)
        net, opt = pt.amp.decorate(net, opt, level="O2")
        # every accumulator up front, as a staged step and a resume make
        # them (a parameter with no gradient here would have none)
        opt.materialize()
        return net, opt

    ids = torch.randint(0, 512, (4, 16), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(1))
    y = ids[:, 0] % 2

    def step(net, opt):
        with pt.auto_cast(level="O2", dtype="bfloat16"):
            loss = pt.nn.functional.cross_entropy(net(ids), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.float().item()

    net, opt = build()
    for _ in range(2):
        step(net, opt)
    lin = CheckpointLineage(str(tmp_path))
    lin.save({"model": net.state_dict(), "opt": opt.state_dict()}, 2,
             async_save=True)
    want = step(net, opt)          # overwrites the tensors in place
    lin.wait()
    after = {k: v.clone() for k, v in net.state_dict().items()}
    net2, opt2 = build()
    target = {"model": net2.state_dict(), "opt": opt2.state_dict()}
    assert lin.load_latest(target) == 2
    opt2.set_state_dict(target["opt"])
    masters = {id(p): w.data_ptr() for p, w in opt2._master_weights.items()}
    opt2.set_state_dict(target["opt"])     # a rewind: in place again
    assert masters == {id(p): w.data_ptr()
                       for p, w in opt2._master_weights.items()}
    assert step(net2, opt2) == want
    for k, v in net2.state_dict().items():
        assert torch.equal(v, after[k]), k


@pytest.mark.cuda
def test_staged_step_rng_restored_across_a_resume_on_card(tmp_path):
    """A staged step with dropout (the model's own CUDA generator,
    registered with the graph, and the default generator) advances its
    Philox offset at every replay; a resume in a fresh model from the
    step-3 snapshot (eager warm-up, then a capture) puts the next steps at
    the uninterrupted run's offsets: the losses are bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed.resumable import ResumableTraining

    def build():
        pt.seed(0)
        net = pt.BertForSequenceClassification(pt.bert_tiny(), num_classes=2,
                                               seed=5)
        opt = pt.AdamW(1e-3, parameters=net.parameters())
        F = pt.nn.functional

        def train_step(x, y):
            with pt.auto_cast(level="O1", dtype="bfloat16"):
                loss = F.cross_entropy(F.dropout(net(x), 0.3, training=True),
                                       y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        return net, opt, pt.jit.to_static(train_step, capture=(net, opt))

    g = torch.Generator("cuda").manual_seed(2)
    batches = [torch.randint(0, 512, (4, 16), device="cuda", generator=g)
               for _ in range(8)]

    def run(step, lo, hi):
        return [float(step(b, b[:, 0] % 2)) for b in batches[lo:hi]]

    net, opt, step = build()
    full = run(step, 0, 8)
    net, opt, step = build()
    rt = ResumableTraining(str(tmp_path), network=net, optimizer=opt,
                           verbose=False)
    rt.restore()
    run(step, 0, 3)
    rt.global_step = 3
    rt._save(0, 3, sync=True)
    net, opt, step = build()
    rt = ResumableTraining(str(tmp_path), network=net, optimizer=opt,
                           verbose=False)
    assert rt.restore() == 3
    assert run(step, 3, 8) == full[3:]


@pytest.mark.cuda
def test_dlinalg_device_backend_on_card():
    """``dlinalg``'s device backend (``"xla"``: torch in float64 on the
    card) against the host numpy f64 reference: GEMM and the sign-fixed
    reduced QR within 1e-12, the results host float64."""
    _need_cuda()
    from paddle_tpu_torch.distributed import dlinalg
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((256, 512)), rng.standard_normal((512, 16))
    got = dlinalg.gemm(a, b, backend="xla")
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, a @ b, rtol=0, atol=1e-12)
    y = rng.standard_normal((512, 16))
    q, r = dlinalg.local_qr(y, backend="xla")
    q0, r0 = dlinalg.local_qr(y)
    np.testing.assert_allclose(q, q0, rtol=0, atol=1e-12)
    np.testing.assert_allclose(r, r0, rtol=0, atol=1e-12)


@pytest.mark.cuda
def test_page_share_import_replays_the_publishers_tokens_on_card():
    """A ``jit=True`` engine imports a 4-page head another engine
    published through a store on this host: the import writes each page
    into the pools in place (their storage unchanged), the imported pages
    equal the publisher's bit for bit, and its replayed rounds, which
    read them, give the publisher's greedy tokens."""
    _need_cuda()
    import socket
    from paddle_tpu_torch import ServingEngine
    from paddle_tpu_torch.distributed.tcp_store import TCPStore
    from paddle_tpu_torch.serving.fleet import PageShareClient
    model = _two_layer_1p3b(torch.bfloat16)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    master = TCPStore("127.0.0.1", port, is_master=True)
    kw = _engine_kw(True)
    engines = [ServingEngine(model, jit=True, engine_id=eid, page_share=(
        PageShareClient(TCPStore("127.0.0.1", port), eid, job="card")),
        **kw) for eid in ("A", "B")]
    for eng in engines:
        eng.warm_ragged()
    a, b = engines
    prompt = np.random.RandomState(4).randint(
        1, model.config.vocab_size, size=70).tolist()
    want = a.generate(prompt, max_new_tokens=8)
    assert a.prefix.share.published == 4
    pools = [(t, t.data_ptr()) for t in b.kv.k + b.kv.v]
    req = b.submit(prompt, max_new_tokens=8)
    b.step()
    assert req.prefix_hit_tokens == 64 and b.prefix.share.remote_hits == 1
    assert all(t.data_ptr() == p for t, p in pools)
    node = -1                  # the trie's root
    for i, mine in enumerate(req.pages[:4]):
        node = a.prefix._index[(node, tuple(prompt[16 * i:16 * i + 16]))]
        assert b.prefix._page_payload(mine) == \
            a.prefix._page_payload(node)
    b.run_until_idle()
    assert req.result(60) == want
    assert b.stats()["graphs"] == b.stats()["distinct_programs"]
    for eng in engines:
        eng.close()
    del master


@pytest.mark.cuda
@pytest.mark.parametrize("kvh", [16, 4])
def test_sharded_ragged_attention_takes_a_contiguous_head_slice_on_card(kvh):
    """A rank's share of ``gpt_1p3b``'s heads at mp 2 (8 of 16 query heads,
    ``kvh / 2`` KV heads): ``sharded_ragged_attention``'s local call
    launches the kernel once on the rank's contiguous head slice and
    matches the unsharded kernel's heads (bf16, phase 4's 4e-3); a
    strided head slice of the pools is refused by the local call and by
    the kernel (which indexes a pool assuming a dense head stride), never
    read as it lies."""
    _need_cuda()
    from paddle_tpu_torch.serving import sharded_ragged_attention
    x = _mixed_launch(16, kvh, 128, seed=24 + kvh, page_size=16,
                      num_pages=32, max_pages=4, T=24)
    args = [_torch(x[n]).cuda() for n in ("q", "k", "v", "rs", "rl", "kl",
                                          "bt")]
    args[:3] = [a.to(torch.bfloat16) for a in args[:3]]
    full = K.ragged_paged_attention(*args)
    # one rank's call: the local call needs no process group
    f = sharded_ragged_attention(None)
    h, kh = 8, kvh // 2
    for r in range(2):
        q = args[0][:, r * h:(r + 1) * h]
        k, v = (a[:, :, r * kh:(r + 1) * kh] for a in args[1:3])
        before = K.ragged_paged_attention.launches
        got = f.local(q.contiguous(), k.contiguous(), v.contiguous(),
                      *args[3:])
        torch.cuda.synchronize()
        assert K.ragged_paged_attention.launches == before + 1
        torch.testing.assert_close(got.float(),
                                   full[:, r * h:(r + 1) * h].float(),
                                   rtol=4e-3, atol=4e-3)
        assert not k.is_contiguous()
        with pytest.raises(ValueError, match="strided view"):
            f.local(q.contiguous(), k, v, *args[3:])
        with pytest.raises(ValueError, match="contiguous"):
            K.ragged_paged_attention(q.contiguous(), k, v, *args[3:])
