"""The port's Transformer layers, BERT and the seq2seq Transformer vs the
JAX package.

Weights go from a ``paddle_tpu`` model or layer built from a seed (its
biases and norm parameters perturbed, so a mis-mapped weight cannot hide)
to the port through ``params_from_paddle_tpu``; inputs are numpy-made.
Tolerances are f32 ``rtol 1e-4 / atol 1e-5`` unless a case says
otherwise. On the CPU the port's attention takes its plain chain (the
flash kernels need a CUDA tensor); the card's runs are in
``chip_smoke.py`` phases 17, 20 and 21.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import BertForMaskedLM as JaxMLM
from paddle_tpu.models import BertForSequenceClassification as JaxCls
from paddle_tpu.models import Seq2SeqTransformer as JaxSeq2Seq
from paddle_tpu.models import bert_tiny as jax_bert_tiny

import paddle_tpu_torch as pt
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch import device as port_device

RTOL, ATOL = 1e-4, 1e-5



@pytest.fixture(autouse=True)
def _port_device():
    """Layers built without a device go to the CPU (the port's default is
    the card); the device is put back after each test."""
    before = port_device.DEFAULT_DEVICE
    port_device.DEFAULT_DEVICE = "cpu"
    yield
    port_device.DEFAULT_DEVICE = before


def _np(t):
    return np.asarray(t._data) if isinstance(t, Tensor) else \
        t.detach().float().numpy()


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _perturb(jm, seed):
    """Random biases and norm parameters (they start at 0 and 1)."""
    rng = np.random.RandomState(seed)
    for name, p in jm.named_parameters():
        if name.endswith("bias"):
            p._data = jnp.asarray(0.05 * rng.randn(*p.shape), jnp.float32)
        elif "norm" in name and name.endswith("weight"):
            p._data = jnp.asarray(1 + 0.1 * rng.randn(*p.shape),
                                  jnp.float32)
    return jm


def _carry(jm, tm):
    arrays = {n: np.asarray(t._data) for n, t in jm.state_dict().items()}
    return pt.params_from_paddle_tpu(arrays, tm)


def _t(a):
    return Tensor(jnp.asarray(a))


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("case", ["self", "cross_kdim", "mask", "cache"])
def test_multi_head_attention_matches_jax(case):
    """Self-attention, cross-attention over another length with
    ``kdim``/``vdim``, an additive mask (the plain chain), and the
    ``cache=`` concat path (output and the grown cache)."""
    paddle.seed(1)
    kdim = 6 if case == "cross_kdim" else None
    jm = _perturb(paddle.nn.MultiHeadAttention(16, 4, kdim=kdim, vdim=kdim),
                  2)
    tm = _carry(jm, pt.nn.MultiHeadAttention(16, 4, kdim=kdim, vdim=kdim))
    q = _x(3, 2, 5, 16)
    kv = _x(4, 2, 7, kdim or 16) if case == "cross_kdim" else q
    args_j, args_t = [_t(q), _t(kv), _t(kv)], [torch.from_numpy(a)
                                              for a in (q, kv, kv)]
    kw_j, kw_t = {}, {}
    if case == "mask":
        m = np.where(np.random.RandomState(5).rand(2, 1, 5, 5) < 0.3, -1e9,
                     0.0).astype(np.float32)
        kw_j["attn_mask"], kw_t["attn_mask"] = _t(m), torch.from_numpy(m)
    if case == "cache":
        prev = [_x(6 + i, 2, 3, 4, 4) for i in range(2)]
        kw_j["cache"] = tuple(_t(a) for a in prev)
        kw_t["cache"] = tuple(torch.from_numpy(a) for a in prev)
    want, got = jm(*args_j, **kw_j), tm(*args_t, **kw_t)
    if case == "cache":
        (want, (wk, wv)), (got, (gk, gv)) = want, got
        assert tuple(gk.shape) == (2, 8, 4, 4)
        _close(gk, wk)
        _close(gv, wv)
    _close(got, want)


@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_transformer_layers_match_jax(normalize_before, activation):
    """``nn.Transformer`` (2 encoder and 2 decoder layers, the final norms
    under ``normalize_before``) with the causal target mask: output, and
    every parameter's gradient of its square sum."""
    paddle.seed(10)
    kw = dict(d_model=16, nhead=4, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=24, dropout=0.0,
              activation=activation, normalize_before=normalize_before)
    jm = _perturb(paddle.nn.Transformer(**kw), 11)
    tm = _carry(jm, pt.nn.Transformer(**kw))
    src, tgt = _x(12, 2, 6, 16), _x(13, 2, 5, 16)
    want = jm(_t(src), _t(tgt),
              tgt_mask=jm.generate_square_subsequent_mask(5))
    got = tm(torch.from_numpy(src), torch.from_numpy(tgt),
             tgt_mask=tm.generate_square_subsequent_mask(5))
    _close(got, want)
    (want * want).sum().backward()
    (got * got).sum().backward()
    jgrads = {n: p.grad for n, p in jm.named_parameters()}
    for name, p in tm.named_parameters():
        _close(p.grad, jgrads[name], rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ BERT
def _bert_pair(jax_cls, port_cls, seed):
    paddle.seed(seed)
    jm = _perturb(jax_cls(jax_bert_tiny()), seed + 1)
    jm.eval()
    tm = _carry(jm, port_cls(pt.bert_tiny(), device="cpu", seed=None))
    tm.eval()
    return jm, tm


def _bert_inputs(seed, vocab=1024, b=2, s=16):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, s))
    types = rng.randint(0, 2, (b, s))
    mask = np.ones((b, s), np.int64)
    mask[1, 11:] = 0
    return ids, types, mask


@pytest.mark.parametrize("masked", [False, True])
def test_bert_sequence_classification_matches_jax(masked):
    """``BertForSequenceClassification(bert_tiny())``: logits and loss,
    with token types, with and without a padding ``attention_mask`` (the
    additive -1e30 mask, which the padded row's logits must feel)."""
    jm, tm = _bert_pair(JaxCls, pt.BertForSequenceClassification, 20)
    ids, types, mask = _bert_inputs(21)
    labels = np.array([0, 1])
    jkw = {"attention_mask": _t(mask)} if masked else {}
    tkw = {"attention_mask": torch.from_numpy(mask)} if masked else {}
    want = jm(_t(ids), _t(types), **jkw)
    got = tm(torch.from_numpy(ids), torch.from_numpy(types), **tkw)
    _close(got, want)
    _close(F.cross_entropy(got, torch.from_numpy(labels)),
           JF.cross_entropy(want, _t(labels)))
    if masked:
        unmasked = tm(torch.from_numpy(ids), torch.from_numpy(types))
        assert not torch.allclose(unmasked[1], got[1], atol=1e-4)
        _close(unmasked[0], got[0])


def test_bert_masked_lm_matches_jax():
    """``BertForMaskedLM(bert_tiny())``: logits, the loss over the vocab,
    and the gradients of the embeddings and the first encoder layer."""
    jm, tm = _bert_pair(JaxMLM, pt.BertForMaskedLM, 30)
    jm.train()
    tm.train()
    ids, types, _ = _bert_inputs(31)
    labels = np.random.RandomState(32).randint(0, 1024, ids.shape)
    want = jm(_t(ids), _t(types))
    got = tm(torch.from_numpy(ids), torch.from_numpy(types))
    _close(got, want)
    jloss = JF.cross_entropy(want.reshape([-1, 1024]),
                             _t(labels.reshape(-1)))
    tloss = F.cross_entropy(got.reshape(-1, 1024),
                            torch.from_numpy(labels.reshape(-1)))
    _close(tloss, jloss)
    jloss.backward()
    tloss.backward()
    jgrads = {n: p.grad for n, p in jm.named_parameters()}
    for name, p in tm.named_parameters():
        if name.startswith(("bert.embeddings", "bert.encoder.layers.0")):
            _close(p.grad, jgrads[name], rtol=1e-4, atol=1e-5)


def test_bert_layer_norm_epsilons_follow_jax():
    """The embeddings' and the MLM head's LayerNorms take
    ``layer_norm_epsilon`` (1e-12); the encoder layers keep 1e-5."""
    tm = pt.BertForMaskedLM(pt.bert_tiny(), device="cpu", seed=None)
    assert tm.bert.embeddings.layer_norm.epsilon == 1e-12
    assert tm.layer_norm.epsilon == 1e-12
    assert {layer.norm1.epsilon for layer in tm.bert.encoder.layers} == {
        1e-5}


# ---------------------------------------------------------------- seq2seq
def test_seq2seq_logits_and_translate_match_jax():
    """``Seq2SeqTransformer`` teacher-forced logits and loss, and the
    greedy ``translate`` tokens, which must be equal."""
    paddle.seed(40)
    kw = dict(d_model=32, nhead=4, num_encoder_layers=1,
              num_decoder_layers=2, dim_feedforward=48, max_len=32)
    jm = _perturb(JaxSeq2Seq(16, 16, **kw), 41)
    tm = _carry(jm, pt.Seq2SeqTransformer(16, 16, device="cpu", seed=None,
                                          **kw))
    rng = np.random.RandomState(42)
    src = rng.randint(2, 16, (3, 6))
    tgt = np.concatenate([np.zeros((3, 1), np.int64),
                          rng.randint(2, 16, (3, 6))], 1)
    want = jm(_t(src), _t(tgt))
    got = tm(torch.from_numpy(src), torch.from_numpy(tgt))
    _close(got, want)
    out = rng.randint(0, 16, (3 * 7,))
    _close(F.cross_entropy(got.reshape(-1, 16), torch.from_numpy(out)),
           JF.cross_entropy(want.reshape([-1, 16]), _t(out)))
    jm.eval()
    tm.eval()
    jtok = np.asarray(jm.translate(_t(src), max_new_tokens=5)._data)
    ttok = tm.translate(torch.from_numpy(src), max_new_tokens=5).numpy()
    np.testing.assert_array_equal(ttok, jtok)
