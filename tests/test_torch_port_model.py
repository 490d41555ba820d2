"""One ragged round through both GPTs: the port vs the JAX package.

``paddle_tpu``'s ``GPTForCausalLM`` is built from a seed (with its biases
and norm parameters perturbed, so a mis-mapped weight cannot hide), its
weights go to ``paddle_tpu_torch`` through ``params_from_paddle_tpu``, and
one mixed ragged round — a decode row, a whole-prompt prefill, a chunk
continuation landing mid-page, an unused row and pad tokens — runs through
both over the same pre-filled page pools. Logits and the written pools
must agree in f32 within ``rtol 2e-3 / atol 2e-4`` (the tolerance of
``tests/test_serving_parity.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.ops.pallas.ragged_attention import ragged_row_index
from paddle_tpu_torch import gpt_tiny, params_from_paddle_tpu

RTOL, ATOL = 2e-3, 2e-4


def _jax_model(seed, **kw):
    paddle.seed(seed)
    m = JaxGPT(jax_gpt_tiny(**kw))
    m.eval()
    rng = np.random.RandomState(seed)
    for name, p in m.named_parameters():
        if name.endswith("bias"):
            p._data = jnp.asarray(0.05 * rng.randn(*p.shape), jnp.float32)
        elif ".ln_" in name or "ln_f" in name:
            p._data = jnp.asarray(1 + 0.1 * rng.randn(*p.shape),
                                  jnp.float32)
    return m


def _weights(m):
    return {n: np.asarray(p._data) for n, p in m.named_parameters()}


@pytest.mark.parametrize("pass_positions", [True, False])
@pytest.mark.parametrize("kv_heads", [None, 2])
def test_ragged_round_logits_and_pools_match_jax(kv_heads, pass_positions):
    jm = _jax_model(11 if kv_heads is None else 12, num_kv_heads=kv_heads)
    cfg = gpt_tiny(num_kv_heads=kv_heads)
    tm = params_from_paddle_tpu(_weights(jm), cfg, device="cpu")
    L, KVH = cfg.num_layers, cfg.num_kv_heads
    Dh = cfg.hidden_size // cfg.num_heads
    page, num_pages, maxp, T = 4, 16, 16, 16
    rng = np.random.RandomState(5)
    k0 = rng.randn(L, num_pages, page, KVH, Dh).astype(np.float32)
    v0 = rng.randn(L, num_pages, page, KVH, Dh).astype(np.float32)
    tokens = rng.randint(1, cfg.vocab_size, size=T).astype(np.int32)
    # decode row at pos 6, fresh 5-token prefill, chunk at 6..8, unused row
    rs = np.array([0, 1, 6, T], np.int32)
    rl = np.array([1, 5, 3, 0], np.int32)
    kl = np.array([7, 5, 9, 0], np.int32)
    bt = np.zeros((4, maxp), np.int32)
    bt[0, :2], bt[1, :2], bt[2, :3] = [3, 4], [5, 6], [7, 8, 9]
    _, pos, valid = ragged_row_index(jnp.asarray(rs), jnp.asarray(rl),
                                     jnp.asarray(kl), T)
    positions = np.where(np.asarray(valid), np.asarray(pos), 0)

    jcaches = [{"ragged": True, "k_pool": Tensor(jnp.asarray(k0[i])),
                "v_pool": Tensor(jnp.asarray(v0[i])),
                "block_tables": Tensor(jnp.asarray(bt)),
                "row_starts": Tensor(jnp.asarray(rs)),
                "row_lens": Tensor(jnp.asarray(rl)),
                "kv_lens": Tensor(jnp.asarray(kl))} for i in range(L)]
    with paddle.no_grad():
        want = jm(Tensor(jnp.asarray(tokens[None])), caches=jcaches,
                  pos_offset=Tensor(jnp.asarray(positions[None])))
    want = np.asarray(want._data)

    t = torch.from_numpy
    tcaches = [{"ragged": True, "k_pool": t(k0[i].copy()),
                "v_pool": t(v0[i].copy()), "block_tables": t(bt),
                "row_starts": t(rs), "row_lens": t(rl), "kv_lens": t(kl)}
               for i in range(L)]
    # without pos_offset the port derives each token's position from the
    # row metadata, as its engine does
    pos_offset = t(positions[None].astype(np.int64)) if pass_positions \
        else None
    with torch.no_grad():
        got = tm(t(tokens[None]), caches=tcaches, pos_offset=pos_offset)
    assert got.shape == want.shape == (1, T, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    for i in range(L):
        for which in ("k_pool", "v_pool"):
            w = np.asarray(jcaches[i][which]._data)
            g = tcaches[i][which].numpy()
            # every page but the scrap page (pad writes race there)
            np.testing.assert_allclose(g[1:], w[1:], rtol=RTOL, atol=ATOL)
