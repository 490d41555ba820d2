"""A user-written Conformer-Transducer (Gulati et al. 2020, arXiv:2005.08100,
at tiny widths: 2 blocks, d 32, 2 heads, conv kernel 8, LSTM 48, V 24)
built over each package's ``nn`` from ``chip_smoke.conformer_transducer``,
the body whose Conformer-M widths phase 27b trains on the card, and
trained against the JAX package on the CPU.

The model is written as a Paddle user writes it, against ``paddle.nn`` /
``paddle.nn.functional``: a two-convolution subsampling, sinusoidal
positions from numpy, Conformer blocks (half-step feed-forwards,
``MultiHeadAttention``, the convolution module's pointwise ``Conv1D``,
``glu``, ``pad`` of the even kernel, depthwise ``Conv1D`` (no bias:
the ``BatchNorm1D`` after it would cancel one), ``BatchNorm1D`` and
``swish``, and a closing ``F.layer_norm``), an
``Embedding`` + ``LSTM`` predictor, a tanh joint, and ``rnnt_loss`` + 0.3
``ctc_loss``. The JAX model's weights carry into the port by name
(``params_from_paddle_tpu``); then, in f32, the step-0 loss within
``rtol 1e-5``, every parameter's gradient within ``rtol 1e-4 / atol
2e-5`` (the gradients pass through 255 ... here 7 steps of log-space
recurrences and two BatchNorms summed in another order), and the losses
and every parameter after two ``AdamW`` steps on a ``NoamDecay`` schedule
within ``rtol 1e-4 / atol 1e-5``. The JAX side runs once, in a
module-scoped fixture (its first step compiles every op)."""
import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle

import paddle_tpu_torch as pt
from paddle_tpu_torch import device as port_device

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import conformer_transducer  # noqa: E402

DIMS = dict(d_model=32, heads=2, blocks=2, ffn=64, kernel=8, n_mels=16,
            pred=48, vocab=24, dropout=0.0, max_frames=64)
B, FRAMES, U = 3, 32, 5


def batch(seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, FRAMES, DIMS["n_mels"]).astype(np.float32)
    labels = rng.randint(1, DIMS["vocab"], (B, U)).astype(np.int64)
    lens = np.array([5, 3, 4], np.int64)
    return feats, labels, lens


def _opt(P, model):
    sched = P.optimizer.lr.NoamDecay(d_model=32, warmup_steps=10,
                                     learning_rate=0.2)
    opt = P.optimizer.AdamW(learning_rate=sched, beta1=0.9, beta2=0.98,
                            epsilon=1e-9, weight_decay=1e-6,
                            parameters=model.parameters())
    return opt, sched


def _train(P, model, args):
    """Loss 0, every gradient of step 0, then two AdamW steps -> (losses,
    gradients, parameters and buffers after)."""
    opt, sched = _opt(P, model)
    losses, grads = [], None
    for step in range(3):
        loss = model(*args)
        losses.append(float(loss))
        if step == 2:
            break
        loss.backward()
        if grads is None:
            grads = {n: _np(p.grad) for n, p in model.named_parameters()}
        opt.step()
        opt.clear_grad()
        sched.step()
    state = {n: _np(t) for n, t in model.state_dict().items()}
    return losses, grads, state


def _np(t):
    if torch.is_tensor(t):
        return t.detach().float().numpy().copy()
    return np.array(t._data)


@pytest.fixture(scope="module")
def jax_side():
    paddle.seed(0)
    jm = conformer_transducer(paddle, **DIMS)
    init = {n: np.array(t._data) for n, t in jm.state_dict().items()}
    names = [n for n, _ in jm.named_parameters()]
    feats, labels, lens = batch()
    out = _train(paddle, jm, [paddle.to_tensor(feats),
                              paddle.to_tensor(labels),
                              paddle.to_tensor(lens)])
    return init, names, out


@pytest.fixture(scope="module")
def port_side(jax_side):
    init, _, _ = jax_side
    before = port_device.DEFAULT_DEVICE
    port_device.DEFAULT_DEVICE = "cpu"
    try:
        pt.seed(0)
        tm = conformer_transducer(pt, **DIMS)
        pt.params_from_paddle_tpu(init, tm)
        names = [n for n, _ in tm.named_parameters()]
        feats, labels, lens = batch()
        out = _train(pt, tm, [torch.from_numpy(feats),
                              torch.from_numpy(labels),
                              torch.from_numpy(lens)])
    finally:
        port_device.DEFAULT_DEVICE = before
    return names, out


def test_parameter_names_carry_by_name(jax_side, port_side):
    """JAX's names, in JAX's order (``lstm._cells_fw.0.weight_ih`` ...),
    so ``params_from_paddle_tpu`` carries every weight with no map."""
    _, jnames, _ = jax_side
    tnames, _ = port_side
    assert tnames == jnames
    assert "lstm._cells_fw.0.weight_ih" in tnames
    assert "blocks.1.conv.dw.weight" in tnames


def test_step0_loss_equals_jax(jax_side, port_side):
    jl, tl = jax_side[2][0], port_side[1][0]
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5)


def test_every_gradient_equals_jax(jax_side, port_side):
    jg, tg = jax_side[2][1], port_side[1][1]
    assert jg.keys() == tg.keys()
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], rtol=1e-4, atol=2e-5,
                                   err_msg=n)


def test_two_adamw_steps_equal_jax(jax_side, port_side):
    """Losses 1 and 2, every parameter and BatchNorm's running statistics
    after two steps. The attention's key biases are held apart: a key
    bias adds one score to every key of a query, which the softmax
    cancels, so their exact gradient is zero, both packages' are f32
    noise (below 1e-5), and Adam turns noise into steps of about the rate
    in either direction: each must have moved by at most two such steps,
    in both packages."""
    (jl, jg, js), (tl, tg, ts) = jax_side[2], port_side[1]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[2] < tl[0]
    assert js.keys() == ts.keys()
    init = jax_side[0]
    lr = 0.2 * 32 ** -0.5 * 10 ** -1.5
    zero = {f"blocks.{i}.attn.k_proj.bias" for i in range(2)}
    for n in js:
        if n in zero:
            assert np.abs(jg[n]).max() < 1e-5 and np.abs(tg[n]).max() < 1e-5
            for s in (js, ts):
                assert np.abs(s[n] - init[n]).max() <= 2.5 * lr
            continue
        np.testing.assert_allclose(ts[n], js[n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)
