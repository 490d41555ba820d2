"""The port's hand-written kernels against their plain versions, on the card.

Marked ``cuda``: they skip without a CUDA device (the kernels have no CPU
mode). This file imports neither JAX nor the JAX package, so it runs on a
GPU machine without them::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_card.py
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import kernels as K


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
