"""Port kernels vs the JAX package: ragged paged attention and LayerNorm.

The same numpy inputs (seeded) go through ``paddle_tpu``'s functions — its
jnp references and its Pallas kernels in interpret mode — and through
``paddle_tpu_torch``'s plain versions, which are what the port's kernel
wrappers run on a CPU tensor. Tolerance: f32 throughout, ``atol 1e-5``
(the two sides sum in different orders). The hand-written kernels
themselves only run on the card: ``tests/test_torch_port_card.py``.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import kernels as K

# the modules themselves (the package re-exports functions of these names)
jax_ln = importlib.import_module("paddle_tpu.ops.pallas.layer_norm")
jax_paged = importlib.import_module("paddle_tpu.ops.pallas.paged_attention")
jax_ragged = importlib.import_module("paddle_tpu.ops.pallas.ragged_attention")

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
    assert K.launch_counts() == {"ragged_paged_attention": 0,
                                 "layer_norm": 0}
