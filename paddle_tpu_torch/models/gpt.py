"""GPT — the training, serving and dense-prefill branches of
``paddle_tpu/models/gpt.py``.

Token + position embeddings, N blocks of [norm -> fused-QKV attention ->
norm -> tanh-GELU MLP] with residuals, a final norm and a weight-tied LM
head: the JAX package's ``GPTForCausalLM`` with parameter names kept
(``gpt.h.0.attn.qkv_proj.weight``, ...; each parameter also carries its
structured name as ``.param_name``, which AdamW hands to
``apply_decay_param_fun``; ``Tensor.name`` is read-only in PyTorch). The
norms are LayerNorm, or RMSNorm with ``use_rms_norm=True``
(``gpt.py:457-462, 490-492``; weight only, names unchanged).

The ported branches of ``GPTAttention.forward``:

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
     "row_lens": [R] int32, "kv_lens": [R] int32,
     "split_scratch": None}        # optional: the engine's own scratch

  :class:`GPTModel` maps the flat tokens to their rows and positions once
  per round (``ragged_row_index``), embeds at those positions unless
  ``pos_offset`` [1, T] is given, and hands every layer the same K/V write
  index. Each layer scatters its K/V into the pools in place, then runs
  ragged paged attention over them (write, then attend). A dict's
  ``"split_scratch"`` is handed to the attention kernel: scratch that the
  caller owns, which a captured CUDA graph of the round needs.
* **paged serving** (``gpt.py:361-399``), the bucketed engine's decode
  step and chunk step: ``input_ids`` [B, S] at per-row offsets
  ``pos_offset`` [B], and every layer's dict::

    {"paged": True, "k_pool": ..., "v_pool": ...,
     "block_tables": [B, max_pages] int32, "positions": [B] int32,
     "chunk_lens": [B] int32,          # chunk step only (S > 1)
     "split_scratch": None}            # optional, the decode kernel's

  The K/V write index is computed once per forward
  (:func:`paged_write_index`). A decode step (S = 1) writes each row's
  token and runs the paged decode kernel with context ``positions + 1``;
  a chunk step writes ``chunk_lens[b]`` tokens per row (padding to the
  scrap page, as zeros) and runs
  :func:`~..ops.kernels.paged_prefill_reference`.
* **dense cache** (``gpt.py:400-413``): a dict whose ``"k"`` is None is
  the prefill: causal attention over the prompt (the flash forward kernel
  on the card), leaving the un-expanded KVH-head K and V in the dict (the
  bucketed engine writes them into its pages; the eager ``generate``
  keeps them). A dict that holds them takes ONE more token (``S = 1``,
  anything else raises ``NotImplementedError`` as in JAX): its K/V is
  concatenated on and it attends over all of them, not causal (the flash
  forward at ``Sq = 1``, ``Sk`` = the tokens so far).
* **static cache** (``gpt.py:318-340``), the compiled ``generate``'s::

    {"static": True, "k": ..., "v": ...,   # [B, T, KVH, Dh], fixed
     "len": 0-d int tensor}                # tokens already cached

  The step's K/V is written at the device cursor ``len``
  (:func:`_cache_write`, no host read), ``len + S`` is left in the dict,
  and the queries attend over all ``T`` keys under the mask
  ``key_pos <= len + q_pos`` built on the device. With a mask
  :func:`~..nn.functional.scaled_dot_product_attention` takes its plain
  f32 chain, as the JAX function takes XLA's (no Pallas kernel computes
  this arm), so a CUDA graph can capture the whole step.

With ``GPTConfig(recompute=True)`` a training forward (``caches=None``)
wraps every block in :func:`~..distributed.fleet.recompute`
(``gpt.py:517-524``): the backward runs each block again instead of
keeping its activations, with the same dropout masks.

Under ``auto_cast`` each op the JAX GPT dispatches by name casts its
inputs as that name says (:mod:`..amp.auto_cast`): the embeddings
(``embedding``), the residual adds (``add``) and the tied head
(``lm_head_tied``, ``gpt.py:545``), besides the layers' own ops. The
tied head is a plain ``torch.matmul`` (no Pallas kernel in the JAX
package either): f32 under O1, a bf16 product under O2.

:meth:`GPTForCausalLM.generate` is the model's own decoding loop
(``gpt.py:552-631``): greedy or sampled, eager over the dense cache or
without one; greedy with the cache runs the static cache as one CUDA
graph a step (:mod:`.generate`).

Each hand-written kernel runs on a CUDA tensor, its plain version on a CPU
tensor. The tensor/sequence-parallel paths (and ``GPTForCausalLMPipe``)
are not ported yet.
"""
from __future__ import annotations

import torch

from .. import nn as pnn
from ..amp import amp_cast
from ..distributed.fleet.recompute import recompute
from ..nn import functional as F
from ..ops.kernels import (paged_attention, paged_prefill_reference,
                           ragged_paged_attention, ragged_row_index)
from ._seeding import init_generator
from .generate import DecodePrograms, generate_compiled

__all__ = ["GPTConfig", "GPTAttention", "GPTMLP", "GPTBlock", "GPTModel",
           "GPTForCausalLM", "GPTPretrainingCriterion", "ragged_write_index",
           "paged_write_index", "gpt_tiny", "gpt_small", "gpt_1p3b",
           "gpt_13b"]


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


def paged_write_index(cache, seq_len):
    """Physical ``(page, slot)`` of the K/V writes of a paged forward of
    ``seq_len`` tokens per row, flattened row-major to ``[B * seq_len]``:
    token ``i`` of row ``b`` sits at ``positions[b] + i`` in
    ``block_tables[b, pos // page]`` at ``pos % page``. A chunk step's
    tokens past ``chunk_lens[b]`` are redirected to the reserved scrap page
    0 (``_pool_write_seq``, ``gpt.py:122-140``), and a third entry, their
    ``keep`` mask [B * S], has :func:`_pool_write` write them as zeros: a
    pad row of the chunk step (length 0, all-zero table) attends over the
    scrap page, which then holds this round's zeros only, so its discarded
    output is the same on every run. A decode step writes every row
    (``_pool_write``, :106-119): inactive slots carry position 0, token 0
    and an all-zero table, so theirs lands on the scrap page as one value
    and only they read it."""
    if seq_len > 1 and "chunk_lens" not in cache:
        raise ValueError(
            "multi-token paged forward is chunked prefill and needs "
            "cache['chunk_lens'] ([B] valid tokens per row); single-token "
            "decode omits it")
    bt = cache["block_tables"]
    page_size = cache["k_pool"].shape[1]
    i = torch.arange(seq_len, device=bt.device)
    pos = cache["positions"].long()[:, None] + i[None, :]        # [B, S]
    logical = (pos // page_size).clamp(0, bt.shape[1] - 1)
    phys = bt.long().gather(1, logical)
    slot = (pos % page_size).reshape(-1)
    if seq_len == 1:
        return phys.reshape(-1), slot
    valid = i[None, :] < cache["chunk_lens"].long()[:, None]
    phys = torch.where(valid, phys, torch.zeros_like(phys))
    return phys.reshape(-1), slot, valid.reshape(-1)


def _add(a, b):
    """``a + b`` as the JAX package's ``add`` op: cast under ``auto_cast``
    (bf16 under O2)."""
    a, b = amp_cast("add", a, b)
    return a + b


def _cache_write(buf, new, ln):
    """Write ``new`` [B, s, KVH, Dh] into the static buffer ``buf``
    [B, T, KVH, Dh] at sequence offset ``ln`` (a 0-d device tensor), in
    place and with no host read (``gpt.py:85-94``). The start is clamped to
    ``T - s`` as ``dynamic_update_slice`` clamps it."""
    s = new.shape[1]
    start = ln.long().clamp(0, buf.shape[1] - s)
    idx = start + torch.arange(s, device=buf.device)
    return buf.index_copy_(1, idx, new.to(buf.dtype))


def _pool_write(pool, new, index):
    """Scatter K or V (``new`` [N, KVH, Dh]) into the page pool at
    ``index`` = (phys, slot), N entries each, or (phys, slot, keep), whose
    entries outside ``keep`` [N] bool are written as zeros. In place: the
    pool tensor is updated where it lies, which takes the place of the JAX
    package's functional ``.at[].set`` on donated pools. Entries
    redirected to the scrap page may share an index; which of them lands
    there is left undefined, so only zeros (a chunk step's padding,
    :func:`paged_write_index`) or one value (a decode step's inactive
    slots) go there where the scrap page is read, and a ragged round's pad
    tokens, whose page nothing reads, may carry any value."""
    new = new.to(pool.dtype)
    if len(index) == 3:
        new = new.masked_fill(~index[2][:, None, None], 0)
    pool[index[0], index[1]] = new
    return pool


class GPTAttention(pnn.Layer):
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
        A ragged or paged cache dict: one serving forward, with
        ``write_index`` = (phys, slot[, keep]) of every token's K/V from
        :func:`ragged_write_index` / :func:`paged_write_index` (one per
        forward, shared by the layers). A static dict: one step over the
        fixed buffers at the cursor ``len``. A dense dict: the prefill
        (``"k"`` None), which stores this layer's K and V in it, or one
        token appended to them."""
        b, s, h = x.shape
        H, KVH, Dh = self.num_heads, self.num_kv_heads, self.head_dim
        qkv = self.qkv_proj(x)
        q = qkv[..., :H * Dh].reshape(b, s, H, Dh)
        k = qkv[..., H * Dh:(H + KVH) * Dh].reshape(b, s, KVH, Dh)
        v = qkv[..., (H + KVH) * Dh:].reshape(b, s, KVH, Dh)
        if cache is None:
            out = F.scaled_dot_product_attention(
                q, self._expand_kv(k), self._expand_kv(v), is_causal=True,
                dropout_p=self.dropout, training=self.training,
                generator=self.dropout_generator)
        elif cache.get("ragged"):
            kp = _pool_write(cache["k_pool"], k.reshape(b * s, KVH, Dh),
                             write_index)
            vp = _pool_write(cache["v_pool"], v.reshape(b * s, KVH, Dh),
                             write_index)
            out = ragged_paged_attention(
                q.reshape(b * s, H, Dh).contiguous(), kp, vp,
                cache["row_starts"], cache["row_lens"], cache["kv_lens"],
                cache["block_tables"], scratch=cache.get("split_scratch"))
        elif cache.get("paged"):
            kp = _pool_write(cache["k_pool"], k.reshape(b * s, KVH, Dh),
                             write_index)
            vp = _pool_write(cache["v_pool"], v.reshape(b * s, KVH, Dh),
                             write_index)
            pos, bt = cache["positions"], cache["block_tables"]
            if s == 1:
                # the row's own K/V is written: context = positions + 1
                out = paged_attention(q[:, 0].contiguous(), kp, vp, bt,
                                      pos + 1,
                                      scratch=cache.get("split_scratch"))
            else:
                out = paged_prefill_reference(q, kp, vp, bt, pos,
                                              cache["chunk_lens"])
        elif cache.get("static"):
            ln = cache["len"]
            kbuf = _cache_write(cache["k"], k, ln)
            vbuf = _cache_write(cache["v"], v, ln)
            cache["len"] = ln + s
            T = kbuf.shape[1]
            # key j visible to query i (at absolute position ln + i) iff
            # j <= ln + i
            key_pos = torch.arange(T, device=x.device)[None, :]
            q_pos = (torch.arange(s, device=x.device) + ln)[:, None]
            mask = (key_pos <= q_pos).reshape(1, 1, s, T)
            out = F.scaled_dot_product_attention(
                q, self._expand_kv(kbuf), self._expand_kv(vbuf),
                attn_mask=mask, dropout_p=0.0, training=False)
        else:
            # dense cache: the prefill (k None) or one appended token; the
            # cache keeps K and V before they are expanded over their
            # groups (the pools hold KVH heads)
            if cache.get("k") is not None:
                if s != 1:
                    raise NotImplementedError(
                        "cached attention appends one token at a time "
                        "after the prefill pass")
                k = torch.cat([cache["k"], k], dim=1)
                v = torch.cat([cache["v"], v], dim=1)
            cache["k"], cache["v"] = k, v
            out = F.scaled_dot_product_attention(
                q, self._expand_kv(k), self._expand_kv(v), is_causal=s > 1,
                dropout_p=0.0, training=False)
        return self.out_proj(out.reshape(b, s, h))


class GPTMLP(pnn.Layer):
    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        h, ffn = config.hidden_size, config.intermediate_size
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.fc1 = pnn.Linear(h, ffn, **kw)
        self.fc2 = pnn.Linear(ffn, h, **kw)
        self.dropout = pnn.Dropout(config.dropout)

    def forward(self, x):
        return self.dropout(self.fc2(F.gelu(self.fc1(x), approximate=True)))


class GPTBlock(pnn.Layer):
    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        eps = config.layer_norm_epsilon
        norm = pnn.RMSNorm if config.use_rms_norm else pnn.LayerNorm
        self.ln_1 = norm(config.hidden_size, epsilon=eps, **kw)
        self.attn = GPTAttention(config, **kw)
        self.ln_2 = norm(config.hidden_size, epsilon=eps, **kw)
        self.mlp = GPTMLP(config, **kw)
        self.dropout = pnn.Dropout(config.dropout)

    def forward(self, x, cache=None, write_index=None):
        x = _add(x, self.dropout(self.attn(self.ln_1(x), cache, write_index)))
        return _add(x, self.mlp(self.ln_2(x)))


class GPTModel(pnn.Layer):
    """Decoder stack -> final norm."""

    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.wte = pnn.Embedding(config.vocab_size, config.hidden_size, **kw)
        self.wpe = pnn.Embedding(config.max_seq_len, config.hidden_size,
                                 **kw)
        self.drop = pnn.Dropout(config.dropout)
        self.h = pnn.LayerList([GPTBlock(config, **kw)
                                for _ in range(config.num_layers)])
        norm = pnn.RMSNorm if config.use_rms_norm else pnn.LayerNorm
        self.ln_f = norm(config.hidden_size,
                         epsilon=config.layer_norm_epsilon, **kw)

    def forward(self, input_ids, caches=None, pos_offset=None):
        """``input_ids`` [B, S] at positions given by ``pos_offset``
        (``gpt.py:494-515``): None or an int shifts an arange (training and
        dense prefill), a 0-d tensor shifts it on the device (the static
        decode step, which a graph captures: no host read), a [B] tensor
        gives each row's offset (paged serving), a [B, S] tensor each
        token's position. ``caches``: None, or one dict per layer (ragged,
        paged, static or dense; see the module docstring). A ragged round
        (``input_ids`` [1, T]) embeds each token at its position in its row
        unless ``pos_offset`` is given (0 for pad tokens)."""
        b, s = input_ids.shape
        dev = input_ids.device
        if caches is not None and len(caches) != len(self.h):
            raise ValueError(f"{len(caches)} cache dicts for "
                             f"{len(self.h)} layers")
        c0 = caches[0] if caches is not None else None
        index = None
        if c0 is not None and c0.get("ragged"):
            rid, pos, valid = ragged_row_index(
                c0["row_starts"], c0["row_lens"], c0["kv_lens"], b * s)
            index = ragged_write_index(c0["block_tables"], rid, pos, valid,
                                       c0["k_pool"].shape[1])
            if pos_offset is None:
                pos_offset = pos.view(b, s)
        elif c0 is not None and c0.get("paged"):
            index = paged_write_index(c0, s)
        if pos_offset is None or not torch.is_tensor(pos_offset):
            start = int(pos_offset or 0)
            pos = torch.arange(start, start + s, device=dev)[None]
        elif pos_offset.dim() == 0:
            pos = (torch.arange(s, device=dev) + pos_offset.long())[None]
        elif pos_offset.dim() == 1:
            pos = pos_offset.long()[:, None] + torch.arange(s,
                                                            device=dev)[None]
        else:
            pos = pos_offset
        x = self.drop(_add(self.wte(input_ids), self.wpe(pos)))
        remat = self.config.recompute and self.training and caches is None
        for i, block in enumerate(self.h):
            if remat:
                x = recompute(block, x)
            else:
                x = block(x, None if caches is None else caches[i], index)
        return self.ln_f(x)


class GPTForCausalLM(pnn.Layer):
    """LM head over :class:`GPTModel`, weight-tied by default.

    ``GPTForCausalLM(config, device=None, dtype=torch.float32, seed=0)``
    builds the model on ``device`` (``cuda`` unless ``"cpu"`` is passed)
    with the JAX layers' initial distributions drawn from ``seed``;
    ``seed=None`` leaves the weights uninitialised for a load
    (:func:`~paddle_tpu_torch.convert.params_from_paddle_tpu`). Dropout
    masks and :meth:`generate`'s samples draw from generators of the
    model's own, seeded from ``seed`` (the default generator when it is
    None)."""

    def __init__(self, config, device=None, dtype=torch.float32, seed=0):
        if config.tensor_parallel or config.sequence_parallel:
            raise NotImplementedError(
                "tensor/sequence-parallel GPT is not ported yet")
        super().__init__()
        dev, gen = init_generator(device, seed)
        self.sample_generator = None
        self.decode_programs = DecodePrograms()
        kw = dict(device=dev, dtype=dtype, generator=gen)
        self.config = config
        self.gpt = GPTModel(config, **kw)
        if not config.tie_word_embeddings:
            self.lm_head = pnn.Linear(config.hidden_size, config.vocab_size,
                                      bias_attr=False, **kw)
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
            self.sample_generator = torch.Generator(device=dev)
            self.sample_generator.manual_seed(int(seed) + 2)
        self.eval()

    @property
    def device(self):
        return self.gpt.wte.weight.device

    @property
    def dtype(self):
        return self.gpt.wte.weight.dtype

    def _head(self, hidden):
        """The LM head alone over ``hidden`` [..., h] (``ln_f``'s output),
        as :meth:`forward` applies it: the serving round takes it over
        only the rows whose logits it reads."""
        if self.config.tie_word_embeddings:
            # ``lm_head_tied`` is on neither AMP list: under O1 it computes
            # in its inputs' promoted type (f32 from ``ln_f``), as the JAX
            # einsum does; under O2 in bf16
            hidden, w = amp_cast("lm_head_tied", hidden, self.gpt.wte.weight)
            dtype = torch.promote_types(hidden.dtype, w.dtype)
            return torch.matmul(hidden.to(dtype), w.to(dtype).t())
        return self.lm_head(hidden)

    def forward(self, input_ids, caches=None, pos_offset=None):
        return self._head(self.gpt(input_ids, caches=caches,
                                   pos_offset=pos_offset))

    def generate(self, input_ids, max_new_tokens=32, temperature=1.0,
                 top_k=None, eos_token_id=None, use_cache=True,
                 compiled=None, generator=None):
        """Autoregressive decoding of ``input_ids`` [B, P] (``gpt.py:
        552-631``) -> ``[B, P + n]`` in ``input_ids``' type. Greedy when
        ``temperature == 0``; else temperature and optional ``top_k``
        sampling, drawn from ``generator`` (default: the model's
        ``sample_generator``). With ``eos_token_id`` a row that emitted it
        keeps emitting it.

        ``compiled`` (default: greedy with the cache) decodes over a static
        cache, one CUDA graph a step on the card (:mod:`.generate`): the
        output is always ``[B, P + max_new_tokens]``, columns after the
        step where every row finished stay 0. Otherwise the loop runs
        eagerly over the dense cache (``use_cache``), or recomputes the
        whole sequence each step, and stops once every row has finished,
        so its output may be shorter. Runs in eval mode and restores the
        training flag."""
        input_ids = torch.as_tensor(input_ids, device=self.device)
        if input_ids.shape[1] + max_new_tokens > self.config.max_seq_len:
            raise ValueError(
                f"prompt ({input_ids.shape[1]}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_seq_len "
                f"({self.config.max_seq_len}); positions past the table "
                "would silently clamp")
        if compiled is None:
            compiled = temperature == 0.0 and use_cache
        if compiled and temperature == 0.0 and use_cache:
            return generate_compiled(self, input_ids, max_new_tokens,
                                     eos_token_id)
        gen = generator if generator is not None else self.sample_generator
        was_training = self.training
        self.eval()
        try:
            with torch.no_grad():
                return self._generate_eager(input_ids, max_new_tokens,
                                            temperature, top_k,
                                            eos_token_id, use_cache, gen)
        finally:
            if was_training:
                self.train()

    def _generate_eager(self, input_ids, max_new_tokens, temperature, top_k,
                        eos_token_id, use_cache, gen):
        caches = [{"k": None, "v": None} for _ in self.gpt.h] \
            if use_cache else None
        out_ids = input_ids
        logits = self(input_ids, caches=caches)
        cur_len = input_ids.shape[1]
        finished = None        # [B, 1]: rows that already emitted eos
        for _ in range(max_new_tokens):
            last = logits[:, -1]
            if temperature == 0.0:
                nxt = last.argmax(dim=-1, keepdim=True)
            else:
                nxt = _sample(last, temperature, top_k, gen)
            nxt = nxt.to(input_ids.dtype)
            if eos_token_id is not None:
                is_eos = nxt == eos_token_id
                if finished is None:
                    finished = is_eos
                else:
                    # finished rows keep emitting eos
                    nxt = torch.where(finished, torch.full_like(
                        nxt, eos_token_id), nxt)
                    finished = finished | is_eos
            out_ids = torch.cat([out_ids, nxt], dim=1)
            if finished is not None and bool(finished.all()):
                break
            if use_cache:
                logits = self(nxt, caches=caches, pos_offset=cur_len)
            else:
                logits = self(out_ids)
            cur_len += 1
        return out_ids


def _sample(last, temperature, top_k, generator):
    """One token a row from the logits ``last`` [B, V] at ``temperature``,
    among the ``top_k`` largest when given -> [B, 1]: the Gumbel-max draw
    that ``jax.random.categorical`` makes, its noise from ``generator``."""
    z = last.float() / max(temperature, 1e-6)
    if top_k is not None:
        kth = torch.topk(z, int(top_k), dim=-1).values[..., -1:]
        z = torch.where(z < kth, torch.full_like(z, -float("inf")), z)
    u = torch.rand(z.shape, device=z.device, generator=generator)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return (z + gumbel).argmax(dim=-1, keepdim=True)


class GPTPretrainingCriterion(pnn.Layer):
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
