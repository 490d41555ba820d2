"""Port kernels vs the JAX package: ragged paged attention, LayerNorm
(forward and gradient), flash attention (forward, dQ, dK/dV) and fused
AdamW.

The same numpy inputs (seeded) go through ``paddle_tpu``'s functions — its
jnp references and its Pallas kernels in interpret mode — and through
``paddle_tpu_torch``'s plain versions, which are what the port's kernel
wrappers run on a CPU tensor. Tolerance: f32, ``atol 1e-5`` (the two
sides sum in different orders) unless a test states another. The
hand-written kernels themselves only run on the card:
``tests/test_torch_port_card.py``.
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import kernels as K

# the modules themselves (the package re-exports functions of these names)
jax_ln = importlib.import_module("paddle_tpu.ops.pallas.layer_norm")
jax_paged = importlib.import_module("paddle_tpu.ops.pallas.paged_attention")
jax_ragged = importlib.import_module("paddle_tpu.ops.pallas.ragged_attention")
jax_flash = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
jax_adamw = importlib.import_module("paddle_tpu.ops.pallas.fused_adamw")

ATOL = 1e-5


def _mixed_launch(H, KVH, D, seed, page_size=4, num_pages=16, max_pages=4,
                  T=16):
    """A decode row, a whole-prompt prefill, a mid-page chunk
    continuation, an unused row (start T, len 0) and padded tail tokens
    (the launch of tests/test_pallas_fused.py)."""
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


@pytest.mark.parametrize("rs,rl,kl,T", [
    ([0, 1, 6, 16], [1, 5, 3, 0], [7, 5, 9, 0], 16),   # mixed + pad tail
    ([8, 8, 8], [0, 0, 0], [0, 0, 0], 8),               # all-pad warm round
    ([0, 3, 3, 7], [3, 0, 4, 1], [9, 0, 4, 30], 8),     # empty middle row
])
def test_ragged_row_index_matches_jax(rs, rl, kl, T):
    args = [np.array(a, np.int32) for a in (rs, rl, kl)]
    want = jax_ragged.ragged_row_index(*[jnp.asarray(a) for a in args], T)
    got = K.ragged_row_index(*[_torch(a) for a in args], T)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("H,KVH,D", [(4, 4, 32), (4, 2, 32), (8, 2, 64)])
def test_ragged_reference_matches_jax_reference_and_pallas(H, KVH, D):
    x = _mixed_launch(H, KVH, D, seed=H * 10 + KVH)
    jargs = [jnp.asarray(x[n]) for n in ("q", "k", "v", "rs", "rl", "kl",
                                         "bt")]
    ref = np.asarray(jax_ragged.ragged_paged_attention_reference(*jargs))
    pallas = np.asarray(jax_ragged.ragged_paged_attention(
        *jargs, interpret=True))
    got = K.ragged_paged_attention_reference(
        *[_torch(x[n]) for n in ("q", "k", "v", "rs", "rl", "kl", "bt")])
    assert got.shape == (16, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=ATOL, atol=ATOL)
    np.testing.assert_array_equal(got.numpy()[9:], 0.0)  # pad tokens zeroed


def test_paged_attention_reference_padded_table_and_zero_context():
    """Sentinel-padded block tables (-1, out of range) are clamped and
    context 0 comes out zeroed, as in the JAX reference and kernel."""
    rng = np.random.RandomState(3)
    B, H, D, PS, NP = 3, 4, 32, 8, 6
    q = rng.randn(B, H, D).astype(np.float32)
    kc = rng.randn(NP, PS, H, D).astype(np.float32)
    vc = rng.randn(NP, PS, H, D).astype(np.float32)
    bt = np.array([[0, 1, -1, -1], [2, 3, 99, 99], [4, -1, -1, -1]],
                  np.int32)
    cl = np.array([12, 16, 0], np.int32)
    jargs = [jnp.asarray(a) for a in (q, kc, vc, bt, cl)]
    ref = np.asarray(jax_paged.paged_attention_reference(*jargs))
    pallas = np.asarray(jax_paged.paged_attention(*jargs, interpret=True))
    got = K.paged_attention_reference(
        *[_torch(a) for a in (q, kc, vc, bt, cl)]).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[2], 0.0)
    np.testing.assert_allclose(got, ref, rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=ATOL, atol=ATOL)


# the small-scale case has variance ~1e-4, where eps=1e-5 moves the result
@pytest.mark.parametrize("shape,affine,scale", [((5, 64), True, 3.0),
                                                ((2, 3, 96), True, 3.0),
                                                ((7, 128), False, 1e-2)])
def test_layer_norm_reference_matches_pallas_and_torch(shape, affine, scale):
    rng = np.random.RandomState(len(shape) * 100 + shape[-1])
    x = ((rng.randn(*shape) + 1 / 3) * scale).astype(np.float32)
    H = shape[-1]
    w = (1 + 0.1 * rng.randn(H)).astype(np.float32) if affine else None
    b = (0.1 * rng.randn(H)).astype(np.float32) if affine else None
    pallas = np.asarray(jax_ln.layer_norm(
        jnp.asarray(x), None if w is None else jnp.asarray(w),
        None if b is None else jnp.asarray(b), eps=1e-5, interpret=True))
    tw = None if w is None else _torch(w)
    tb = None if b is None else _torch(b)
    got = K.layer_norm_reference(_torch(x), tw, tb, eps=1e-5)
    lib = torch.nn.functional.layer_norm(_torch(x), (H,), tw, tb, eps=1e-5)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), lib.numpy(), rtol=ATOL,
                               atol=ATOL)


def test_layer_norm_reference_keeps_bf16():
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(0))
    out = K.layer_norm_reference(x.to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               K.layer_norm_reference(x).numpy(),
                               atol=3e-2)


def test_wrappers_run_plain_version_on_cpu_without_counting():
    """On CPU tensors the wrappers return their plain version's result
    and leave the launch counters alone (no kernel ran)."""
    x = _mixed_launch(4, 2, 64, seed=9)
    args = [_torch(x[n]) for n in ("q", "k", "v", "rs", "rl", "kl", "bt")]
    K.reset_launch_counts()
    out = K.ragged_paged_attention(*args)
    torch.testing.assert_close(out, K.ragged_paged_attention_reference(
        *args), rtol=0, atol=0)
    h = torch.randn(6, 64)
    torch.testing.assert_close(K.layer_norm(h), K.layer_norm_reference(h),
                               rtol=0, atol=0)
    q, k, v = (torch.randn(1, 9, 2, 16) for _ in range(3))
    o, lse = K.flash_fwd(q, k, v, 0.25, True)
    delta = K.flash_delta(o, q)
    K.flash_bwd_dq(q, k, v, q, lse, delta, 0.25, True)
    K.flash_bwd_dkv(q, k, v, q, lse, delta, 0.25, True)
    w = torch.randn(5)
    K.fused_adamw([w], [torch.randn(5)], [torch.zeros(5)], [torch.zeros(5)],
                  [1e-3], 0.9, 0.999, 1e-8, [0.0], [10.0], [1000.0])
    assert K.launch_counts() == {name: 0 for name in K.KERNELS}


# ---------------------------------------------------------- flash attention
def _bhsd(x):
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d)


def _port_flash_vjp(q, k, v, g, causal, kv_len=None):
    """O, lse and (dQ, dK, dV) from the three plain versions, in
    ``[B*H, S, D]``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    o, lse = K.flash_fwd_reference(q, k, v, scale, causal, kv_len)
    delta = (g.float() * o.float()).sum(-1)
    dq = K.flash_bwd_dq_reference(q, k, v, g, lse, delta, scale, causal,
                                  kv_len)
    dk, dv = K.flash_bwd_dkv_reference(q, k, v, g, lse, delta, scale,
                                       causal, kv_len)
    return o, lse, (dq, dk, dv)


# (S, Sk, block): aligned; unaligned S padded by JAX to its 8-row block
# (kv_len masking); queries and keys of different lengths
@pytest.mark.parametrize("s,sk,block", [(32, 32, 16), (20, 20, 8),
                                        (12, 28, 8)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_flash_references_match_pallas_forward_and_vjp(s, sk, block,
                                                       causal, dtype, tol):
    """The three flash plain versions against JAX's
    ``flash_attention_bshd(interpret=True)``: the output, and the
    gradients from ``jax.vjp`` (its ``custom_vjp`` runs the dQ and dK/dV
    Pallas kernels). bf16: both sides round to bf16 at other places, so
    ``rtol/atol 2e-2`` (a few bf16 ulps)."""
    rng = np.random.RandomState(s * 7 + sk + causal)
    b, h, d = 1, 2, 16
    q, g = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, sk, h, d).astype(np.float32) for _ in range(2))
    jdt = getattr(jnp, dtype)
    jargs = [jnp.asarray(a, jdt) for a in (q, k, v)]
    want, vjp = jax.vjp(lambda q_, k_, v_: jax_flash.flash_attention_bshd(
        q_, k_, v_, causal=causal, block_q=block, block_k=block,
        interpret=True), *jargs)
    wgrads = vjp(jnp.asarray(g, jdt))
    tdt = getattr(torch, dtype)
    o, _, grads = _port_flash_vjp(
        *[_bhsd(_torch(a).to(tdt)) for a in (q, k, v, g)], causal)
    assert o.dtype == tdt and all(x.dtype == tdt for x in grads)

    def bshd(x):
        return x.float().reshape(b, h, -1, d).transpose(1, 2).numpy()

    np.testing.assert_allclose(bshd(o), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    for name, got, w in zip(("dq", "dk", "dv"), grads, wgrads):
        np.testing.assert_allclose(bshd(got), np.asarray(w, np.float32),
                                   rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_references_match_pallas_kernels_with_kv_len(causal):
    """``_flash_fwd`` and ``_flash_bwd`` called directly on inputs padded
    past ``kv_len`` (the padded path of ``flash_attention_bshd``): O, the
    lse lane and dQ/dK/dV of the plain versions with the same ``kv_len``
    agree."""
    rng = np.random.RandomState(11 + causal)
    bh, s, d, kv_len, blk = 2, 24, 16, 19, 8
    q, k, v, g = (rng.randn(bh, s, d).astype(np.float32) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    o, lse = jax_flash._flash_fwd(jq, jk, jv, scale, causal, blk, blk, True,
                                  kv_len=kv_len)
    dq, dk, dv = jax_flash._flash_bwd((jq, jk, jv, o, lse[..., :1]), jg,
                                      scale, causal, blk, blk, True, kv_len)
    po, plse, (pdq, pdk, pdv) = _port_flash_vjp(
        *[_torch(a) for a in (q, k, v, g)], causal, kv_len)
    for name, got, want in (("o", po, o), ("lse", plse, lse[..., 0]),
                            ("dq", pdq, dq), ("dk", pdk, dk),
                            ("dv", pdv, dv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=ATOL, atol=ATOL, err_msg=name)
    # keys past kv_len get no gradient
    np.testing.assert_array_equal(pdk.numpy()[:, kv_len:], 0.0)


def test_flash_row_without_a_valid_key_is_zero_with_floored_lse():
    q, k, v = (torch.randn(1, 4, 16) for _ in range(3))
    o, lse = K.flash_fwd_reference(q, k, v, 0.25, False, kv_len=0)
    assert torch.equal(o, torch.zeros_like(o))
    assert bool((lse < -1e29).all()) and bool(torch.isfinite(lse).all())


def test_flash_attention_bshd_autograd_matches_plain_chain():
    """The autograd Function (the wrappers' CPU path) against autograd
    through a dense softmax chain, causal, S not a power of two."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 13, 3, 32, generator=g, requires_grad=True)
               for _ in range(3))
    ct = torch.randn(2, 13, 3, 32, generator=g)
    got = torch.autograd.grad((K.flash_attention_bshd(q, k, v) * ct).sum(),
                              (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(32)
    s = s.masked_fill(~torch.ones(13, 13, dtype=torch.bool).tril(), -1e30)
    o = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)
    want = torch.autograd.grad((o * ct).sum(), (q, k, v))
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, rtol=ATOL, atol=ATOL)


# -------------------------------------------------------------- fused AdamW
@pytest.mark.parametrize("shape,w_dtype,wd", [((300, 70), "float32", 0.01),
                                              ((48, 96), "bfloat16", 0.0),
                                              ((5,), "float32", 0.1)])
def test_fused_adamw_reference_matches_pallas(shape, w_dtype, wd):
    rng = np.random.RandomState(len(shape) + shape[0])
    w = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    m = (0.1 * rng.randn(*shape)).astype(np.float32)
    v = rng.rand(*shape).astype(np.float32)
    args = (1e-2, 0.9, 0.95, 1e-8, wd, 1.0 / (1 - 0.9 ** 3),
            1.0 / (1 - 0.95 ** 3))
    want = jax_adamw.fused_adamw(jnp.asarray(w, getattr(jnp, w_dtype)),
                                 jnp.asarray(g), jnp.asarray(m),
                                 jnp.asarray(v), *args, interpret=True)
    tw = _torch(w).to(getattr(torch, w_dtype))
    got = K.fused_adamw_reference(tw, _torch(g), _torch(m), _torch(v),
                                  *args)
    assert got[0].dtype == tw.dtype and got[1].dtype == torch.float32
    for name, a, b_ in zip(("w", "m", "v"), got, want):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b_, np.float32), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def test_fused_adamw_wrapper_updates_a_mixed_list_in_place():
    """The multi-tensor wrapper (its CPU path) over tensors of mixed size
    and type, each with its own lr, wd and bias corrections, equals the
    plain version tensor by tensor."""
    rng = np.random.RandomState(4)
    ws = [_torch(rng.randn(*s).astype(np.float32))
          for s in ((7, 3), (20000,), (1,))]
    ws.append(_torch(rng.randn(9).astype(np.float32)).to(torch.bfloat16))
    gs = [torch.from_numpy(rng.randn(*w.shape).astype(np.float32))
          for w in ws]
    ms = [torch.zeros(w.shape) for w in ws]
    vs = [torch.zeros(w.shape) for w in ws]
    lrs, wds = [1e-3, 2e-3, 1e-2, 1e-3], [0.1, 0.0, 0.1, 0.05]
    bc1, bc2 = [10.0, 5.26, 10.0, 3.69], [1000.0, 500.25, 1000.0, 333.6]
    want = [K.fused_adamw_reference(*x) for x in zip(
        ws, gs, ms, vs, lrs, [0.9] * 4, [0.999] * 4, [1e-8] * 4, wds, bc1,
        bc2)]
    ids = [id(w) for w in ws]
    K.fused_adamw(ws, gs, ms, vs, lrs, 0.9, 0.999, 1e-8, wds, bc1, bc2)
    assert [id(w) for w in ws] == ids
    for (w2, m2, v2), w, m, v in zip(want, ws, ms, vs):
        assert w.dtype == w2.dtype
        for a, b_ in ((w, w2), (m, m2), (v, v2)):
            torch.testing.assert_close(a, b_, rtol=0, atol=0)


# ---------------------------------------------------------- LayerNorm grad
@pytest.mark.parametrize("shape,affine", [((5, 64), True), ((2, 3, 96), True),
                                          ((7, 128), False)])
def test_layer_norm_gradient_matches_pallas_custom_vjp(shape, affine):
    """The port's LayerNorm backward (``LayerNormFunction`` over the plain
    ``_bwd_math``) against the gradients of the JAX kernel's
    ``custom_vjp``."""
    rng = np.random.RandomState(shape[-1] + affine)
    x = ((rng.randn(*shape) + 0.3) * 2).astype(np.float32)
    ct = rng.randn(*shape).astype(np.float32)
    H = shape[-1]
    w = (1 + 0.1 * rng.randn(H)).astype(np.float32) if affine else None
    b = (0.1 * rng.randn(H)).astype(np.float32) if affine else None
    if affine:
        _, vjp = jax.vjp(lambda x_, w_, b_: jax_ln.layer_norm(
            x_, w_, b_, eps=1e-5, interpret=True), jnp.asarray(x),
            jnp.asarray(w), jnp.asarray(b))
    else:
        _, vjp = jax.vjp(lambda x_: jax_ln.layer_norm(
            x_, None, None, eps=1e-5, interpret=True), jnp.asarray(x))
    want = vjp(jnp.asarray(ct))
    tx = _torch(x).requires_grad_()
    tw = _torch(w).requires_grad_() if affine else None
    tb = _torch(b).requires_grad_() if affine else None
    y = K.LayerNormFunction.apply(tx, tw, tb, 1e-5)
    ins = (tx, tw, tb) if affine else (tx,)
    got = torch.autograd.grad(y, ins, _torch(ct))
    for name, a, b_ in zip(("dx", "dw", "db"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=1e-4,
                                   atol=ATOL, err_msg=name)
