"""GPT for serving — the ragged paged-KV branch of ``paddle_tpu/models/gpt.py``.

Token + position embeddings, N blocks of [LayerNorm -> fused-QKV attention
-> LayerNorm -> tanh-GELU MLP] with residuals, a final LayerNorm and a
weight-tied LM head: the JAX package's ``GPTForCausalLM`` with parameter
names kept (``gpt.h.0.attn.qkv_proj.weight``, ...).

This slice ports the **ragged cache branch** only (``gpt.py:341-360``): the
input is one serving round's flat token stream ``[1, T]`` and every layer's
cache dict carries the round's row metadata and its page pools::

    {"ragged": True, "k_pool": ..., "v_pool": ...,   # [P, page, KVH, Dh]
     "block_tables": [R, max_pages] int32, "row_starts": [R] int32,
     "row_lens": [R] int32, "kv_lens": [R] int32}

:class:`GPTModel` maps the flat tokens to their rows and positions once per
round (``ragged_row_index``), embeds at those positions unless
``pos_offset`` [1, T] is given, and hands every layer the same K/V write
index. Each layer scatters its K/V into the pools in place, then runs
ragged paged attention over them (write, then attend): the hand-written
kernel on a CUDA tensor, its plain version on a CPU tensor. The static,
paged, chunked-prefill and dense branches, ``generate`` and the
tensor/sequence-parallel paths are not ported yet.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import nn as pnn
from ..device import resolve_device
from ..nn.functional import gelu
from ..ops.kernels import ragged_paged_attention, ragged_row_index

__all__ = ["GPTConfig", "GPTAttention", "GPTMLP", "GPTBlock", "GPTModel",
           "GPTForCausalLM", "ragged_write_index", "gpt_tiny", "gpt_small",
           "gpt_1p3b", "gpt_13b"]


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=None, max_seq_len=1024,
                 dropout=0.1, layer_norm_epsilon=1e-5, tensor_parallel=False,
                 sequence_parallel=False, use_rms_norm=False,
                 tie_word_embeddings=True, recompute=False,
                 tp_overlap=None, num_kv_heads=None):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        # grouped-query attention: num_kv_heads < num_heads shares each K/V
        # head across num_heads // num_kv_heads query heads; the serving
        # pools hold only the KV heads
        self.num_kv_heads = int(num_kv_heads or num_heads)
        if num_heads % self.num_kv_heads:
            raise ValueError(
                f"num_heads={num_heads} must be divisible by "
                f"num_kv_heads={self.num_kv_heads} (query heads are "
                "grouped evenly over KV heads)")
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.max_seq_len = max_seq_len
        self.dropout = dropout
        self.layer_norm_epsilon = layer_norm_epsilon
        self.tensor_parallel = tensor_parallel
        self.sequence_parallel = sequence_parallel
        self.use_rms_norm = use_rms_norm
        self.tie_word_embeddings = tie_word_embeddings
        self.recompute = recompute
        self.tp_overlap = tp_overlap


def gpt_tiny(**kw):
    return GPTConfig(vocab_size=256, hidden_size=64, num_layers=2,
                     num_heads=4, max_seq_len=64, dropout=0.0, **kw)


def gpt_small(**kw):
    return GPTConfig(hidden_size=768, num_layers=12, num_heads=12, **kw)


def gpt_1p3b(**kw):
    return GPTConfig(hidden_size=2048, num_layers=24, num_heads=16, **kw)


def gpt_13b(**kw):
    return GPTConfig(hidden_size=5120, num_layers=40, num_heads=40, **kw)


def ragged_write_index(block_tables, row_ids, positions, valid, page_size):
    """Physical ``(page, slot)`` of every flat token's K/V write: token
    ``t`` of row ``row_ids[t]`` at ``positions[t]`` lands in
    ``block_tables[row, pos // page]`` at ``pos % page``; pad tokens go to
    the reserved scrap page 0, slot 0 (never read). One per round, shared
    by every layer."""
    logical = (positions // page_size).clamp(0, block_tables.shape[1] - 1)
    phys = block_tables[row_ids.long(), logical.long()]
    zero = torch.zeros_like(phys)
    phys = torch.where(valid, phys, zero)
    slot = torch.where(valid, positions % page_size, zero)
    return phys.long(), slot.long()


def _pool_write_ragged(pool, new, index):
    """Scatter the flat stream's K or V (``new`` [T, KVH, Dh]) into the
    page pool at ``index`` = (phys, slot). In place: the pool tensor is
    updated where it lies, which takes the place of the JAX package's
    functional ``.at[].set`` on donated pools."""
    phys, slot = index
    pool[phys, slot] = new.to(pool.dtype)
    return pool


class GPTAttention(nn.Module):
    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        self.num_heads = config.num_heads
        self.num_kv_heads = config.num_kv_heads
        self.head_dim = config.hidden_size // config.num_heads
        h = config.hidden_size
        # fused QKV: [q (H*Dh) | k (KVH*Dh) | v (KVH*Dh)]
        qkv_out = h + 2 * self.num_kv_heads * self.head_dim
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.qkv_proj = pnn.Linear(h, qkv_out, **kw)
        self.out_proj = pnn.Linear(h, h, **kw)

    def forward(self, x, cache, write_index):
        """``write_index`` = (phys, slot) of every flat token's K/V, from
        :func:`ragged_write_index` (one per round, shared by the layers)."""
        b, s, h = x.shape
        qkv = self.qkv_proj(x)
        h_q = self.num_heads * self.head_dim
        kv_w = self.num_kv_heads * self.head_dim
        q = qkv[..., :h_q].reshape(b * s, self.num_heads, self.head_dim)
        k = qkv[..., h_q:h_q + kv_w].reshape(b * s, self.num_kv_heads,
                                             self.head_dim)
        v = qkv[..., h_q + kv_w:].reshape(b * s, self.num_kv_heads,
                                          self.head_dim)
        kp = _pool_write_ragged(cache["k_pool"], k, write_index)
        vp = _pool_write_ragged(cache["v_pool"], v, write_index)
        out = ragged_paged_attention(
            q.contiguous(), kp, vp, cache["row_starts"], cache["row_lens"],
            cache["kv_lens"], cache["block_tables"])
        return self.out_proj(out.reshape(b, s, h))


class GPTMLP(nn.Module):
    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        h, ffn = config.hidden_size, config.intermediate_size
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.fc1 = pnn.Linear(h, ffn, **kw)
        self.fc2 = pnn.Linear(ffn, h, **kw)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x), approximate=True))


class GPTBlock(nn.Module):
    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        eps = config.layer_norm_epsilon
        self.ln_1 = pnn.LayerNorm(config.hidden_size, epsilon=eps, **kw)
        self.attn = GPTAttention(config, **kw)
        self.ln_2 = pnn.LayerNorm(config.hidden_size, epsilon=eps, **kw)
        self.mlp = GPTMLP(config, **kw)

    def forward(self, x, cache, write_index):
        x = x + self.attn(self.ln_1(x), cache, write_index)
        return x + self.mlp(self.ln_2(x))


class GPTModel(nn.Module):
    """Decoder stack -> final norm."""

    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.wte = pnn.Embedding(config.vocab_size, config.hidden_size, **kw)
        self.wpe = pnn.Embedding(config.max_seq_len, config.hidden_size,
                                 **kw)
        self.h = nn.ModuleList([GPTBlock(config, **kw)
                                for _ in range(config.num_layers)])
        self.ln_f = pnn.LayerNorm(config.hidden_size,
                                  epsilon=config.layer_norm_epsilon, **kw)

    def forward(self, input_ids, caches, pos_offset=None):
        """``input_ids`` [1, T] flat round; ``caches`` one ragged dict per
        layer; ``pos_offset`` [1, T] per-token absolute positions
        (``gpt.py:497-501``), by default each token's position in its row
        (0 for pad tokens)."""
        if not caches or not all(c is not None and c.get("ragged")
                                 for c in caches):
            raise NotImplementedError(
                "paddle_tpu_torch ports the ragged serving branch only; "
                "pass one cache dict with 'ragged': True per layer")
        c0 = caches[0]
        T = input_ids.shape[0] * input_ids.shape[1]
        rid, pos, valid = ragged_row_index(c0["row_starts"], c0["row_lens"],
                                           c0["kv_lens"], T)
        index = ragged_write_index(c0["block_tables"], rid, pos, valid,
                                   c0["k_pool"].shape[1])
        if pos_offset is None:
            pos_offset = pos.view(input_ids.shape)
        x = self.wte(input_ids) + self.wpe(pos_offset)
        for block, cache in zip(self.h, caches):
            x = block(x, cache, index)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """LM head over :class:`GPTModel`, weight-tied by default.

    ``GPTForCausalLM(config, device=None, dtype=torch.float32, seed=0)``
    builds the model on ``device`` (``cuda`` unless ``"cpu"`` is passed)
    with random weights drawn from ``seed``; ``seed=None`` leaves them
    uninitialised for a load (:func:`~paddle_tpu_torch.convert.
    params_from_paddle_tpu`)."""

    def __init__(self, config, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        if config.use_rms_norm or config.tensor_parallel \
                or config.sequence_parallel:
            raise NotImplementedError(
                "RMSNorm and tensor/sequence-parallel GPT are not ported yet")
        dev = resolve_device(device)
        gen = None
        if seed is not None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
        kw = dict(device=dev, dtype=dtype, generator=gen)
        self.config = config
        self.gpt = GPTModel(config, **kw)
        if not config.tie_word_embeddings:
            self.lm_head = pnn.Linear(config.hidden_size, config.vocab_size,
                                      bias=False, **kw)
        self.eval()

    @property
    def device(self):
        return self.gpt.wte.weight.device

    @property
    def dtype(self):
        return self.gpt.wte.weight.dtype

    def forward(self, input_ids, caches, pos_offset=None):
        hidden = self.gpt(input_ids, caches=caches, pos_offset=pos_offset)
        if self.config.tie_word_embeddings:
            return torch.matmul(hidden, self.gpt.wte.weight.t())
        return self.lm_head(hidden)
