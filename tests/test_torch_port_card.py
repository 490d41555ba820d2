"""The port's hand-written kernels against their plain versions, on the card.

Marked ``cuda``: they skip without a CUDA device (the kernels have no CPU
mode). This file imports neither JAX nor the JAX package, so it runs on a
GPU machine without them::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_card.py
"""
import importlib
import math

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
