"""``paddle_tpu_torch.incubate`` — its functions, ``incubate.nn.functional``
and the ``incubate.nn`` layers — against the JAX package on the CPU.

Every case of ``tests/torch_incubate_cases.py`` (the table
``chip_smoke.py``'s phase 28a runs on the card) goes through both
packages on the same numpy-made inputs: the outputs, and the gradients of
the floating inputs (and of a layer's parameters, carried from the JAX
layer by ``params_from_paddle_tpu``) under one cotangent, within rtol
1e-4 / atol 1e-5 in f32. Then the JAX choices the port keeps, each
pinned: RoPE ignores ``position_ids`` and always rotates neox-style,
``block_multihead_attention`` only decodes, ``flash_attention`` returns
``(out, None)`` and refuses ``return_softmax``; dropout held by its
moments. Last, the decoder of ``chip_smoke.py``'s phase 28b at tiny
widths in both packages: the same weights give the same loss, every
gradient and two AdamW steps."""
import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle

import paddle_tpu_torch as pt
from paddle_tpu_torch import device as port_device

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))
import torch_incubate_cases as C  # noqa: E402
from chip_smoke import rope_decoder  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default():
    before = port_device.DEFAULT_DEVICE
    port_device.DEFAULT_DEVICE = "cpu"
    yield
    port_device.DEFAULT_DEVICE = before


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _leaves(o)]
    return [out]


def _cotangents(shapes):
    rng = np.random.RandomState(1)
    return [np.asarray(rng.randn(*s), np.float32) for s in shapes]


def _jax_side(case):
    """-> (outputs, input gradients, {param: gradient}, JAX state) as
    numpy."""
    _, call, makers = case
    arrays = [m() for m in makers]
    ins = [paddle.to_tensor(a, stop_gradient=a.dtype.kind != "f")
           for a in arrays]
    build = getattr(call, "build", None)
    params, state = {}, {}
    if build is not None:
        paddle.seed(0)
        layer = build(paddle.incubate.nn)
        out = layer(*ins)
        params = dict(layer.named_parameters())
        state = {n: np.array(t._data) for n, t in layer.state_dict().items()}
    else:
        out = call(paddle, *ins)
    outs = _leaves(out)
    diff = [o for o in outs if not o.stop_gradient]
    targets = [t for t in ins if not t.stop_gradient] + list(params.values())
    grads = []
    if diff and targets:
        cots = [paddle.to_tensor(c, dtype=str(np.array(o._data).dtype))
                for c, o in zip(_cotangents([tuple(o.shape) for o in diff]),
                                diff)]
        grads = paddle.grad(diff, targets, cots, allow_unused=True)
    n_in = len(targets) - len(params)
    g = [None if x is None else np.array(x._data) for x in grads]
    return ([np.array(o._data) for o in outs], g[:n_in],
            dict(zip(params, g[n_in:])), state)


def _port_side(case, state):
    _, call, makers = case
    arrays = [m() for m in makers]
    ins = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    for t in ins:
        if t.is_floating_point():
            t.requires_grad_(True)
    build = getattr(call, "build", None)
    params = {}
    if build is not None:
        layer = build(pt.incubate.nn)
        pt.params_from_paddle_tpu(state, layer)
        out = layer(*ins)
        params = dict(layer.named_parameters())
    else:
        out = call(pt, *ins)
    outs = _leaves(out)
    diff = [o for o in outs if o.requires_grad]
    targets = [t for t in ins if t.requires_grad] + list(params.values())
    grads = []
    if diff and targets:
        cots = [torch.from_numpy(c) for c in
                _cotangents([tuple(o.shape) for o in diff])]
        grads = torch.autograd.grad(diff, targets, cots, allow_unused=True)
    n_in = len(targets) - len(params)
    g = [None if x is None else x.detach().numpy() for x in grads]
    return ([o.detach().numpy() for o in outs], g[:n_in],
            dict(zip(params, g[n_in:])))


# JAX's attention compositions scale by numpy's float64 ``np.sqrt``, which
# x64 promotes to float64 outputs; the port keeps the input's type
X64_PROMOTED = {"fused_multi_head_attention post-LN",
                "fused_multi_head_attention pre-LN",
                "masked_multihead_attention",
                "variable_length_memory_efficient_attention causal",
                "fused_multi_transformer", "FusedMultiHeadAttention",
                "FusedMultiHeadAttention pre-LN",
                "FusedTransformerEncoderLayer", "FusedMultiTransformer"}


@pytest.mark.parametrize("case", C.CASES, ids=[c[0] for c in C.CASES])
def test_case_matches_jax(case):
    """Outputs (dtype, shape, values) and every gradient equal JAX's within
    rtol 1e-4 / atol 1e-5. Where JAX promotes to float64
    (``X64_PROMOTED``), the port's output is float32 and its values are
    held against JAX's."""
    j_out, j_in, j_par, state = _jax_side(case)
    t_out, t_in, t_par = _port_side(case, state)
    assert len(t_out) == len(j_out)
    for a, b in zip(t_out, j_out):
        want = np.float64 if case[0] in X64_PROMOTED else a.dtype
        assert a.shape == b.shape and b.dtype == want
        assert a.dtype == (np.float32 if b.dtype == np.float64 else b.dtype)
        np.testing.assert_allclose(a, b, rtol=C.RTOL, atol=C.ATOL)
    assert len(t_in) == len(j_in) and t_par.keys() == j_par.keys()
    for a, b in list(zip(t_in, j_in)) + [(t_par[n], j_par[n])
                                         for n in j_par]:
        if a is None or b is None:      # unused: None on one side, zeros
            assert not np.any(a if b is None else b)
            continue
        np.testing.assert_allclose(a, b, rtol=C.RTOL, atol=C.ATOL)


def test_rope_keeps_jax_choices():
    """``position_ids`` and ``use_neox_rotary_style=False`` change nothing
    (neox halves always), and the result is always a 3-tuple."""
    rng = np.random.RandomState(0)
    q, k = (rng.randn(2, 5, 2, 8).astype(np.float32) for _ in range(2))
    pos = np.array([[4, 3, 2, 1, 0]] * 2)
    for P, wrap in ((pt, torch.from_numpy), (paddle, paddle.to_tensor)):
        base = P.incubate.fused_rotary_position_embedding(wrap(q))
        other = P.incubate.fused_rotary_position_embedding(
            wrap(q), wrap(k), position_ids=wrap(pos),
            use_neox_rotary_style=False)
        assert len(base) == 3 and base[1] is None and base[2] is None
        assert len(other) == 3 and other[2] is None
        np.testing.assert_allclose(_np(base[0]), _np(other[0]), rtol=1e-6,
                                   atol=1e-6)
    # neox: the second half of the head rotates against the first
    t = pt.incubate.fused_rotary_position_embedding(torch.from_numpy(q))[0]
    s, c = pt.incubate._rope_tables(5, 8, "cpu")
    half = torch.from_numpy(q)[..., 4:]
    np.testing.assert_allclose(
        t[..., :4].numpy(),
        (torch.from_numpy(q)[..., :4] * c[..., :4] - half * s[..., :4])
        .numpy(), rtol=1e-6, atol=1e-6)


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.array(t._data)


def test_block_multihead_attention_only_decodes():
    """JAX's reading (``:253-265``): ``seq_lens_decoder`` are the context
    lengths; the encoder lengths and ``seq_lens_this_time`` are not
    read. Equal to ``incubate.paged_attention`` over the same pool."""
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.randn(2, 4, 64).astype(np.float32))
    kc, vc = (torch.from_numpy(rng.randn(5, 16, 4, 64).astype(np.float32))
              for _ in range(2))
    bt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    lens = torch.tensor([20, 7], dtype=torch.int32)
    IF = pt.incubate.nn.functional
    a = IF.block_multihead_attention(q, kc, vc, torch.tensor([99, 0]), lens,
                                     torch.tensor([5, 5]), block_tables=bt)
    b = IF.block_multihead_attention(q, kc, vc, None, lens, None,
                                     block_tables=bt)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(
        a, pt.incubate.paged_attention(q, kc, vc, bt, lens), rtol=0, atol=0)
    with pytest.raises(ValueError, match="block_tables"):
        IF.block_multihead_attention(q, kc, vc, None, lens, None)


def test_functional_fused_rms_norm_passes_its_bias_on():
    """The deviation kept (ROADMAP Queue 3): the JAX alias drops
    ``norm_bias`` (``incubate/nn/functional/__init__.py:120-123``); the
    port's passes it on to the top-level function, which takes it in both
    packages."""
    rng = np.random.RandomState(4)
    x, w, b = (rng.randn(*s).astype(np.float32) for s in ((3, 8), (8,), (8,)))
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    got = pt.incubate.nn.functional.fused_rms_norm(tx, tw, tb)
    torch.testing.assert_close(got, pt.incubate.fused_rms_norm(tx, tw, tb))
    jx, jw, jb = map(paddle.to_tensor, (x, w, b))
    np.testing.assert_allclose(
        got.numpy(), np.array(paddle.incubate.fused_rms_norm(jx, jw, jb)
                              ._data), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        np.array(paddle.incubate.nn.functional.fused_rms_norm(jx, jw, jb)
                 ._data),
        np.array(paddle.incubate.nn.functional.fused_rms_norm(jx, jw)._data))


def test_flash_attention_returns_out_and_none_and_refuses_softmax():
    q = torch.randn(1, 4, 2, 16)
    out, sm = pt.incubate.flash_attention(q, q, q, causal=True)
    assert sm is None and out.shape == q.shape
    for P, x in ((pt, q), (paddle, paddle.to_tensor(q.numpy()))):
        with pytest.raises(NotImplementedError, match="softmax"):
            P.incubate.flash_attention(x, x, x, return_softmax=True)


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_moments(mode):
    """``fused_dropout_add`` and ``fused_bias_dropout_residual_layer_norm``
    at p 0.3 draw from the port's generator: the kept share is within
    4 sigma of 0.7, kept values are x / 0.7 (upscale) or x, dropped ones
    0; ``FusedDropoutAdd`` in eval mode is x + y."""
    pt.seed(5)
    x = torch.full((200, 200), 2.0)
    y = torch.zeros(200, 200)
    out = pt.incubate.nn.functional.fused_dropout_add(x, y, p=0.3,
                                                      mode=mode)
    kept = out != 0
    share = float(kept.float().mean())
    assert abs(share - 0.7) < 4 * np.sqrt(0.21 / x.numel())
    want = 2.0 / 0.7 if mode == "upscale_in_train" else 2.0
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], want))
    layer = pt.incubate.nn.FusedDropoutAdd(p=0.3, mode=mode).eval()
    torch.testing.assert_close(layer(x, y), x + y)
    ln = pt.incubate.nn.functional.fused_bias_dropout_residual_layer_norm(
        x, y, dropout_rate=0.3, mode=mode)
    assert torch.isfinite(ln).all()


# ----------------------------------------- phase 28b's decoder, tiny widths
DIMS = dict(vocab=64, hidden=32, layers=2, heads=2, ffn=64, max_len=16)
B, S = 2, 8
LR = 1e-2


def _batch():
    rng = np.random.RandomState(0)
    return rng.randint(0, 64, (B, S)), rng.randint(0, 64, (B, S))


def _train(P, model, ids, labels):
    """Loss 0 and every gradient of step 0, then two AdamW steps -> (three
    losses, gradients, parameters after)."""
    opt = P.optimizer.AdamW(learning_rate=LR, parameters=model.parameters(),
                            weight_decay=0.01)
    losses, grads = [], None
    for step in range(3):
        loss = model(ids, labels)
        losses.append(float(loss))
        if step == 2:
            break
        loss.backward()
        if grads is None:
            grads = {n: _np(p.grad) for n, p in model.named_parameters()}
        opt.step()
        opt.clear_grad()
    return losses, grads, {n: _np(p) for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def decoder_runs():
    ids, labels = _batch()
    paddle.seed(0)
    jm = rope_decoder(paddle, **DIMS)
    init = {n: np.array(t._data) for n, t in jm.state_dict().items()}
    jax_run = _train(paddle, jm, paddle.to_tensor(ids),
                     paddle.to_tensor(labels))
    before = port_device.DEFAULT_DEVICE
    port_device.DEFAULT_DEVICE = "cpu"
    try:
        tm = rope_decoder(pt, **DIMS)
        pt.params_from_paddle_tpu(init, tm)
        port_run = _train(pt, tm, torch.from_numpy(ids),
                          torch.from_numpy(labels))
    finally:
        port_device.DEFAULT_DEVICE = before
    return jax_run, port_run


def test_decoder_loss_gradients_and_adamw_steps_match_jax(decoder_runs):
    """fused_rms_norm, RoPE, flash_attention and the user's GELU
    ``PyLayer``: loss within rtol 1e-5, every gradient and every
    parameter after two AdamW steps within rtol 1e-4 / atol 1e-5, and the
    loss falls. An element whose step-0 gradient is below 1e-6 (a key
    bias the softmax nearly cancels: f32 noise, ~2e-7 here) moves by
    Adam's noise-driven steps of about the rate in either package, so it
    is held within two such steps of JAX's instead."""
    (jl, jg, jp), (tl, tg, tp) = decoder_runs
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[2] < tl[0]
    assert tg.keys() == jg.keys() and tp.keys() == jp.keys()
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)
    for n in jp:
        noise = np.abs(jg[n]) < 1e-6
        np.testing.assert_allclose(tp[n][~noise], jp[n][~noise], rtol=1e-4,
                                   atol=1e-5, err_msg=n)
        assert np.abs(tp[n][noise] - jp[n][noise]).max(initial=0) <= 2 * LR
