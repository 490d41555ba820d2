"""The port's recurrent layers and beam search against the JAX package's
on the CPU. Each layer is built in both packages and its weights carried
by ``params_from_paddle_tpu`` (the JAX names, ``_cells_fw.0.weight_ih``
...); the outputs, final states and every parameter's and the input's
gradient under numpy-made cotangents match within ``rtol / atol 1e-5``
(f32), with ``sequence_length`` masking, reversed and bidirectional runs,
several layers and initial states. Beam search over a carried
``LSTMCell`` gives JAX's ids and scores."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import device as port_device

from torch_nn_parity import check, rand, to_np

TOL = 1e-5


@pytest.fixture(autouse=True)
def _port_device():
    before = port_device.DEFAULT_DEVICE
    port_device.DEFAULT_DEVICE = "cpu"
    yield
    port_device.DEFAULT_DEVICE = before


def _carry(jl, tl):
    jnames = [n for n, _ in jl.named_parameters()]
    assert jnames == [n for n, _ in tl.named_parameters()]
    return pt.params_from_paddle_tpu(
        {n: np.asarray(t._data) for n, t in jl.state_dict().items()}, tl)


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _run_both(jl, tl, x, *rest, jrest=None, seed=5):
    """Forward both on ``x`` (+ ``rest``), compare every output leaf, then
    backpropagate the same cotangents and compare the input's and every
    parameter's gradient."""
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x).requires_grad_(True)
    jout = _flat(jl(jx, *(jrest if jrest is not None else rest)))
    tout = _flat(tl(tx, *[torch.from_numpy(np.asarray(r))
                          if isinstance(r, np.ndarray) else r
                          for r in rest]))
    assert len(jout) == len(tout)
    rng = np.random.RandomState(seed)
    jl_loss, tl_loss = 0, 0
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.detach().numpy(), to_np(j), rtol=TOL,
                                   atol=TOL)
        c = rng.randn(*t.shape).astype(np.float32)
        jl_loss = jl_loss + (j * paddle.to_tensor(c)).sum()
        tl_loss = tl_loss + (t * torch.from_numpy(c)).sum()
    jl_loss.backward()
    tl_loss.backward()
    np.testing.assert_allclose(tx.grad.numpy(), to_np(jx.grad), rtol=TOL,
                               atol=TOL)
    for (n, a), (_, b) in zip(jl.named_parameters(), tl.named_parameters()):
        np.testing.assert_allclose(b.grad.numpy(), to_np(a.grad), rtol=TOL,
                                   atol=TOL, err_msg=n)


@pytest.mark.parametrize("cls,kw", [("SimpleRNNCell", {}),
                                    ("SimpleRNNCell", {"activation": "relu"}),
                                    ("LSTMCell", {}), ("GRUCell", {})])
@pytest.mark.parametrize("with_states", [False, True])
def test_cell_step_equals_jax(cls, kw, with_states):
    """One step of each cell, from zeros or from given states: the gate
    orders (LSTM i, f, c, o; GRU r, z, c with r on the hidden
    projection) and the returned ``(h, h)`` / ``(h, (h, c))``. The JAX
    cell's own backward fails for a one-state cell (its single-output
    ``apply``), so the gradients are JAX's through ``RNN(cell)`` over one
    time-major step: the same function."""
    jl, tl = getattr(paddle.nn, cls)(5, 6, **kw), \
        getattr(pt.nn, cls)(5, 6, **kw)
    _carry(jl, tl)
    x = rand(1, 3, 5)
    n = 2 if cls == "LSTMCell" else 1
    st = [rand(2 + i, 3, 6) for i in range(n)] if with_states else \
        [np.zeros((3, 6), np.float32)] * n
    jst = tuple(paddle.to_tensor(s) for s in st)
    tst = tuple(torch.from_numpy(s) for s in st)
    targ = (tst if n == 2 else tst[0]) if with_states else None
    jarg = (jst if n == 2 else jst[0]) if with_states else None
    jy, jnew = jl(paddle.to_tensor(x), jarg)
    ty, tnew = tl(torch.from_numpy(x), targ)
    for j, t in zip(_flat((jy, jnew)), _flat((ty, tnew))):
        np.testing.assert_allclose(t.detach().numpy(), to_np(j), rtol=TOL,
                                   atol=TOL)
    jrnn = paddle.nn.RNN(jl, time_major=True)
    trnn = pt.nn.RNN(tl, time_major=True)
    _run_both(jrnn, trnn, x[None], tst if n == 2 else tst[0],
              jrest=[jst if n == 2 else jst[0]])


@pytest.mark.parametrize("cls", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
@pytest.mark.parametrize("reverse,time_major", [(False, False),
                                                (True, False),
                                                (False, True)])
def test_rnn_over_a_cell_with_lengths_equals_jax(cls, reverse, time_major):
    """``RNN(cell)`` over [B, T, I] (or time-major), rows of 7, 4 and 1
    steps: states freeze and outputs are zero past a row's length."""
    jl = paddle.nn.RNN(getattr(paddle.nn, cls)(4, 5), is_reverse=reverse,
                       time_major=time_major)
    tl = pt.nn.RNN(getattr(pt.nn, cls)(4, 5), is_reverse=reverse,
                   time_major=time_major)
    _carry(jl, tl)
    x = rand(6, 7, 3, 4) if time_major else rand(6, 3, 7, 4)
    lens = np.array([7, 4, 1], np.int64)
    _run_both(jl, tl, x, None, lens,
              jrest=[None, paddle.to_tensor(lens)])


def test_birnn_equals_jax():
    jl = paddle.nn.BiRNN(paddle.nn.GRUCell(4, 5), paddle.nn.GRUCell(4, 5))
    tl = pt.nn.BiRNN(pt.nn.GRUCell(4, 5), pt.nn.GRUCell(4, 5))
    _carry(jl, tl)
    lens = np.array([6, 2], np.int64)
    _run_both(jl, tl, rand(7, 2, 6, 4), None, lens,
              jrest=[None, paddle.to_tensor(lens)])


@pytest.mark.parametrize("cls", ["SimpleRNN", "LSTM", "GRU"])
@pytest.mark.parametrize("direction,layers,time_major,states", [
    ("forward", 1, False, False),
    ("bidirect", 2, False, True),
    ("bidirectional", 3, True, False),
    ("forward", 2, True, True),
])
def test_multi_layer_rnn_equals_jax(cls, direction, layers, time_major,
                                    states):
    """Multi-layer, bidirectional runs with ``sequence_length`` and
    initial states ``[layers * directions, B, H]``; the final states
    stack the same way."""
    jl = getattr(paddle.nn, cls)(4, 5, num_layers=layers,
                                 direction=direction, time_major=time_major)
    tl = getattr(pt.nn, cls)(4, 5, num_layers=layers, direction=direction,
                             time_major=time_major)
    _carry(jl, tl)
    B, T = 3, 6
    x = rand(8, T, B, 4) if time_major else rand(8, B, T, 4)
    lens = np.array([6, 3, 5], np.int64)
    D = 1 if direction == "forward" else 2
    init, jinit = None, None
    if states:
        n = 2 if cls == "LSTM" else 1
        arrs = [rand(9 + i, layers * D, B, 5) for i in range(n)]
        init = tuple(torch.from_numpy(a) for a in arrs)
        jinit = tuple(paddle.to_tensor(a) for a in arrs)
        if n == 1:
            init, jinit = init[0], jinit[0]
    _run_both(jl, tl, x, init, lens, jrest=[jinit, paddle.to_tensor(lens)])


def test_lstm_names_and_init_are_jax_s():
    """``LSTM(640, 640)``'s parameter names and shapes are JAX's, drawn
    from ``Uniform(-1/sqrt(640), 1/sqrt(640))``."""
    jl, tl = paddle.nn.LSTM(64, 640), pt.nn.LSTM(64, 640)
    assert [(n, tuple(p.shape)) for n, p in tl.named_parameters()] == \
        [(n, tuple(p.shape)) for n, p in jl.named_parameters()]
    assert [n for n, _ in tl.named_parameters()][0] == \
        "_cells_fw.0.weight_ih"
    w = tl._cells_fw[0].weight_hh.detach()
    bound = 1 / 640 ** 0.5
    assert float(w.abs().max()) <= bound
    assert abs(float(w.std()) - bound / 3 ** 0.5) < 2e-4


def test_initial_states_of_both_bases_equal_jax():
    x = torch.zeros(4, 3)
    st = pt.nn.LSTMCell(3, 5).get_initial_states(x)
    assert len(st) == 2 and st[0].shape == (4, 5) and \
        st[0].dtype == torch.float32
    assert pt.nn.GRUCell(3, 5).get_initial_states(x, init_value=2.0) \
        .eq(2.0).all()

    class Cell(pt.nn.RNNCellBase):
        hidden_size, state_shape = 5, [(5,), (5,)]

    class JCell(paddle.nn.RNNCellBase):
        hidden_size, state_shape = 5, [(5,), (5,)]

    got = Cell().get_initial_states(x, init_value=1.0)
    want = JCell().get_initial_states(paddle.to_tensor(x.numpy()),
                                      init_value=1.0)
    assert len(got) == len(want) == 2
    np.testing.assert_array_equal(got[1].numpy(), to_np(want[1]))


def _decoder_pair(V=12, E=6, H=8):
    jemb, temb = paddle.nn.Embedding(V, E), pt.nn.Embedding(V, E)
    jcell, tcell = paddle.nn.LSTMCell(E, H), pt.nn.LSTMCell(E, H)
    jout, tout = paddle.nn.Linear(H, V), pt.nn.Linear(H, V)
    for j, t in ((jemb, temb), (jcell, tcell), (jout, tout)):
        _carry(j, t)
    return (jemb, jcell, jout), (temb, tcell, tout)


@pytest.mark.parametrize("beam,steps", [(4, 16), (3, 5)])
def test_beam_search_ids_and_scores_equal_jax(beam, steps):
    """``BeamSearchDecoder`` + ``dynamic_decode`` over the same carried
    embedding, ``LSTMCell`` and output projection, from the same initial
    states: identical ids [B, beam, T] and scores within 1e-5."""
    (je, jc, jo), (te, tc, to) = _decoder_pair()
    h0 = rand(20, 2, 8)
    jdec = paddle.nn.BeamSearchDecoder(jc, 1, 2, beam, embedding_fn=je,
                                       output_fn=jo)
    tdec = pt.nn.BeamSearchDecoder(tc, 1, 2, beam, embedding_fn=te,
                                   output_fn=to)
    jids, jsc = paddle.nn.dynamic_decode(
        jdec, (paddle.to_tensor(h0), paddle.to_tensor(h0 * 0.5)),
        max_step_num=steps)
    tids, tsc = pt.nn.dynamic_decode(
        tdec, (torch.from_numpy(h0), torch.from_numpy(h0 * 0.5)),
        max_step_num=steps)
    assert tids.dtype == torch.int64
    np.testing.assert_array_equal(tids.numpy(), to_np(jids))
    np.testing.assert_allclose(tsc.numpy(), to_np(jsc), rtol=1e-5,
                               atol=1e-5)


def test_gather_tree_and_sequence_mask_equal_jax():
    rng = np.random.RandomState(21)
    ids = rng.randint(0, 9, (5, 2, 3)).astype(np.int64)
    parents = rng.randint(0, 3, (5, 2, 3)).astype(np.int64)
    check(JF.gather_tree, TF.gather_tree, [ids, parents], grad=False)
    lens = np.array([[3, 0], [5, 1]], np.int64)
    check(JF.sequence_mask, TF.sequence_mask, [lens], grad=False)
    check(lambda a: JF.sequence_mask(a, 7, "float32"),
          lambda a: TF.sequence_mask(a, 7, "float32"), [lens], grad=False)


@pytest.mark.parametrize("call", [
    lambda: TF.sequence_mask([3, 5]),
    lambda: TF.class_center_sample([1, 3], 10, 4)[0]],
    ids=["sequence_mask", "class_center_sample"])
def test_host_lengths_follow_the_current_device(call):
    """A list input goes to the current device, as every entry point's
    does: the CPU once the CPU is chosen, and by default the card, which
    raises without one as ``resolve_device`` does."""
    assert call().device.type == "cpu"
    port_device.DEFAULT_DEVICE = "cuda"
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
