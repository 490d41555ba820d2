"""GPT — the training (no-cache) and ragged serving branches of
``paddle_tpu/models/gpt.py``.

Token + position embeddings, N blocks of [LayerNorm -> fused-QKV attention
-> LayerNorm -> tanh-GELU MLP] with residuals, a final LayerNorm and a
weight-tied LM head: the JAX package's ``GPTForCausalLM`` with parameter
names kept (``gpt.h.0.attn.qkv_proj.weight``, ...; each parameter also
carries its structured name as ``.param_name``, which AdamW hands to
``apply_decay_param_fun``; ``Tensor.name`` is read-only in PyTorch).

Two branches are ported:

* **training / no cache** (``caches=None``, ``gpt.py:414-429`` and
  ``:505-527``): positions from an arange shifted by ``pos_offset``,
  embedding dropout, the blocks with their dropouts, ``ln_f``. Attention
  expands the KV heads over their groups (``_expand_kv``) and calls
  :func:`~..nn.functional.scaled_dot_product_attention` causal, which runs
  the flash kernels (forward and backward) on the card.
  :class:`GPTPretrainingCriterion` (``gpt.py:704-727``) is its loss.
* **ragged serving** (``gpt.py:341-360``): the input is one serving
  round's flat token stream ``[1, T]`` and every layer's cache dict
  carries the round's row metadata and its page pools::

    {"ragged": True, "k_pool": ..., "v_pool": ...,   # [P, page, KVH, Dh]
     "block_tables": [R, max_pages] int32, "row_starts": [R] int32,
     "row_lens": [R] int32, "kv_lens": [R] int32}

  :class:`GPTModel` maps the flat tokens to their rows and positions once
  per round (``ragged_row_index``), embeds at those positions unless
  ``pos_offset`` [1, T] is given, and hands every layer the same K/V write
  index. Each layer scatters its K/V into the pools in place, then runs
  ragged paged attention over them (write, then attend).

Each hand-written kernel runs on a CUDA tensor, its plain version on a CPU
tensor. The static, paged, chunked-prefill and dense cache branches,
``generate``, ``recompute`` and the tensor/sequence-parallel paths are not
ported yet.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import nn as pnn
from ..device import resolve_device
from ..nn import functional as F
from ..ops.kernels import ragged_paged_attention, ragged_row_index

__all__ = ["GPTConfig", "GPTAttention", "GPTMLP", "GPTBlock", "GPTModel",
           "GPTForCausalLM", "GPTPretrainingCriterion", "ragged_write_index",
           "gpt_tiny", "gpt_small", "gpt_1p3b", "gpt_13b"]


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
        self.dropout = config.dropout
        # the attention-probability dropout's generator (None: the default
        # one); GPTForCausalLM sets it with every Dropout's
        self.dropout_generator = None
        h = config.hidden_size
        # fused QKV: [q (H*Dh) | k (KVH*Dh) | v (KVH*Dh)]
        qkv_out = h + 2 * self.num_kv_heads * self.head_dim
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.qkv_proj = pnn.Linear(h, qkv_out, **kw)
        self.out_proj = pnn.Linear(h, h, **kw)

    def _expand_kv(self, t):
        """Broadcast each KV head over its query-head group for the dense
        attention path ([B, S, KVH, Dh] -> [B, S, H, Dh]); the ragged
        serving path attends grouped instead."""
        groups = self.num_heads // self.num_kv_heads
        return t if groups == 1 else t.repeat_interleave(groups, dim=2)

    def forward(self, x, cache=None, write_index=None):
        """``cache=None``: causal attention over ``x`` [B, S, h] (training).
        A ragged cache dict: one serving round, with ``write_index`` =
        (phys, slot) of every flat token's K/V from
        :func:`ragged_write_index` (one per round, shared by the
        layers)."""
        b, s, h = x.shape
        qkv = self.qkv_proj(x)
        h_q = self.num_heads * self.head_dim
        kv_w = self.num_kv_heads * self.head_dim
        q = qkv[..., :h_q].reshape(b, s, self.num_heads, self.head_dim)
        k = qkv[..., h_q:h_q + kv_w].reshape(b, s, self.num_kv_heads,
                                             self.head_dim)
        v = qkv[..., h_q + kv_w:].reshape(b, s, self.num_kv_heads,
                                          self.head_dim)
        if cache is None:
            out = F.scaled_dot_product_attention(
                q, self._expand_kv(k), self._expand_kv(v), is_causal=True,
                dropout_p=self.dropout, training=self.training,
                generator=self.dropout_generator)
            return self.out_proj(out.reshape(b, s, h))
        q = q.reshape(b * s, self.num_heads, self.head_dim)
        k = k.reshape(b * s, self.num_kv_heads, self.head_dim)
        v = v.reshape(b * s, self.num_kv_heads, self.head_dim)
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
        self.dropout = pnn.Dropout(config.dropout)

    def forward(self, x):
        return self.dropout(self.fc2(F.gelu(self.fc1(x), approximate=True)))


class GPTBlock(nn.Module):
    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        eps = config.layer_norm_epsilon
        self.ln_1 = pnn.LayerNorm(config.hidden_size, epsilon=eps, **kw)
        self.attn = GPTAttention(config, **kw)
        self.ln_2 = pnn.LayerNorm(config.hidden_size, epsilon=eps, **kw)
        self.mlp = GPTMLP(config, **kw)
        self.dropout = pnn.Dropout(config.dropout)

    def forward(self, x, cache=None, write_index=None):
        x = x + self.dropout(self.attn(self.ln_1(x), cache, write_index))
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
        self.drop = pnn.Dropout(config.dropout)
        self.h = nn.ModuleList([GPTBlock(config, **kw)
                                for _ in range(config.num_layers)])
        self.ln_f = pnn.LayerNorm(config.hidden_size,
                                  epsilon=config.layer_norm_epsilon, **kw)

    def forward(self, input_ids, caches=None, pos_offset=None):
        """``caches=None`` (training): ``input_ids`` [B, S] at positions
        ``pos_offset + arange(S)`` (``gpt.py:512-515``; ``pos_offset`` an
        int, default 0). Ragged serving: ``input_ids`` [1, T] flat round,
        ``caches`` one ragged dict per layer, ``pos_offset`` [1, T]
        per-token absolute positions (``gpt.py:497-501``), by default each
        token's position in its row (0 for pad tokens)."""
        if caches is None:
            s = input_ids.shape[1]
            start = int(pos_offset or 0)
            pos = torch.arange(start, start + s, device=input_ids.device)
            x = self.drop(self.wte(input_ids) + self.wpe(pos[None]))
            for block in self.h:
                x = block(x)
            return self.ln_f(x)
        if len(caches) != len(self.h) or not all(
                c is not None and c.get("ragged") for c in caches):
            raise NotImplementedError(
                "paddle_tpu_torch ports the training (caches=None) and "
                "ragged serving branches; pass one cache dict with "
                "'ragged': True per layer")
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
        for name, p in self.named_parameters():
            p.param_name = name
        if seed is not None:
            # dropout masks draw from one generator of their own, seeded
            # from ``seed``; without a seed they draw from the default one
            drop_gen = torch.Generator(device=dev)
            drop_gen.manual_seed(int(seed) + 1)
            for m in self.modules():
                if isinstance(m, pnn.Dropout):
                    m.generator = drop_gen
                elif isinstance(m, GPTAttention):
                    m.dropout_generator = drop_gen
        self.eval()

    @property
    def device(self):
        return self.gpt.wte.weight.device

    @property
    def dtype(self):
        return self.gpt.wte.weight.dtype

    def forward(self, input_ids, caches=None, pos_offset=None):
        hidden = self.gpt(input_ids, caches=caches, pos_offset=pos_offset)
        if self.config.tie_word_embeddings:
            # ``lm_head_tied`` is on neither AMP list: it computes in its
            # inputs' type (f32 from ``ln_f`` under O1)
            return torch.matmul(hidden, self.gpt.wte.weight.t())
        return self.lm_head(hidden)


class GPTPretrainingCriterion(nn.Module):
    """Mean token cross-entropy of the LM logits (``gpt.py:704-727``):
    ``criterion(logits [B, S, V], labels [B, S], loss_mask=None)``, the
    mean over every token, or over the tokens ``loss_mask`` marks. Labels
    equal to -100 contribute 0 (and still count in the plain mean, as in
    the JAX package)."""

    def __init__(self, config=None):
        super().__init__()
        if config is not None and config.tensor_parallel:
            raise NotImplementedError("the tensor-parallel criterion is not "
                                      "ported")

    def forward(self, logits, labels, loss_mask=None):
        b, s, v = logits.shape
        losses = F.cross_entropy(logits.reshape(b * s, v),
                                 labels.reshape(b * s), reduction="none")
        if loss_mask is not None:
            m = loss_mask.reshape(b * s).float()
            return (losses * m).sum() / m.sum()
        return losses.mean()
