"""The port's long-tail losses and activations against the JAX package's
on the CPU: CTC and RNN-T at T 255 × U 64 (f32; the port's RNN-T computes
each step's recurrence over U with one ``logcumsumexp``, JAX a nested
scan, and both sum 255 steps of log-space terms in another order: the
loss within ``rtol 1e-5``, the logits' gradient within ``atol 5e-5``
against gradients of up to ~0.1; 7.2e-6 was the largest difference
seen, the port's RNN-T holding each lattice row relative to its first
entry), the hierarchical sigmoid, margin cross-entropy and the
rest of ``extra.py`` / ``long_tail.py``, and the loss layers: forward
values, dtypes and input gradients from numpy-made inputs within ``rtol /
atol 1e-5``. Where torch's own op computes another function (CTC on
unnormalised scores, ``max_unpool``'s default size), a test shows that
the port computes JAX's."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import device as port_device

from torch_nn_parity import check, rand, to_np


@pytest.fixture(autouse=True)
def _port_device():
    before = port_device.DEFAULT_DEVICE
    port_device.DEFAULT_DEVICE = "cpu"
    yield
    port_device.DEFAULT_DEVICE = before


def _labels(seed, B, U, V, lo, hi):
    rng = np.random.RandomState(seed)
    lab = rng.randint(1, V, (B, U)).astype(np.int32)
    lens = rng.randint(lo, hi + 1, (B,)).astype(np.int32)
    return lab, lens


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_ctc_loss_at_t255_equals_jax(reduction):
    """Unnormalised scores [T 255, B 3, C 7], labels of 40-64 tokens, one
    row shorter in time; ``norm_by_times`` with ``none``."""
    T, B, C, L = 255, 3, 7, 64
    x = rand(1, T, B, C)
    lab, lab_len = _labels(2, B, L, C, 40, 64)
    in_len = np.array([255, 200, 255], np.int32)
    kw = dict(reduction=reduction, norm_by_times=reduction == "none")
    check(lambda a, b, c, d: JF.ctc_loss(a, b, c, d, **kw),
          lambda a, b, c, d: TF.ctc_loss(a, b, c, d, **kw),
          [x, lab, in_len, lab_len], rtol=1e-5, atol=1e-5, grad_atol=5e-5)


def test_ctc_loss_log_softmaxes_its_input_unlike_torch():
    """JAX's (and the port's) CTC log-softmaxes the scores itself; torch's
    ``F.ctc_loss`` takes them as log-probabilities. On log-softmaxed
    input the three agree (the ``mean`` divides by the label lengths in
    all three); on raw scores torch's differs."""
    T, B, C = 30, 2, 5
    x = torch.from_numpy(rand(3, T, B, C, scale=2.0))
    lab = torch.tensor([[1, 2, 3, 1], [4, 4, 2, 0]])
    in_len, lab_len = torch.tensor([30, 25]), torch.tensor([4, 3])
    port = TF.ctc_loss(x, lab, in_len, lab_len)
    lp = torch.log_softmax(x, -1)
    ref = torch.nn.functional.ctc_loss(lp, lab, in_len, lab_len)
    np.testing.assert_allclose(float(port), float(ref), rtol=1e-5)
    raw = torch.nn.functional.ctc_loss(x, lab, in_len, lab_len)
    assert abs(float(raw) - float(port)) > 1e-2


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_rnnt_loss_at_t255_u64_equals_jax(reduction):
    """Logits [B 2, T 255, U + 1 = 65, V 6]; label lengths 40 and 64, one
    row 180 frames long: the loss and the logits' gradient."""
    B, T, U, V = 2, 255, 64, 6
    x = rand(4, B, T, U + 1, V)
    lab, _ = _labels(5, B, U, V, 1, 1)
    lab_len = np.array([40, 64], np.int32)
    in_len = np.array([180, 255], np.int32)
    check(lambda a, b, c, d: JF.rnnt_loss(a, b, c, d, reduction=reduction),
          lambda a, b, c, d: TF.rnnt_loss(a, b, c, d, reduction=reduction),
          [x, lab, in_len, lab_len], rtol=1e-5, atol=1e-5, grad_atol=5e-5)


def _rnnt_f64(logits, lab, in_len, lab_len):
    """The RNN-T loss (batch mean) by its textbook lattice, cell by cell,
    in f64: ``a[t, u] = logaddexp(a[t - 1, u] + blank[t - 1, u], a[t, u -
    1] + emit[t, u - 1])``, ``ll = a[T - 1, U] + blank[T - 1, U]``."""
    lp = torch.log_softmax(logits.double(), -1)
    losses = []
    for b in range(lp.shape[0]):
        T, U = int(in_len[b]), int(lab_len[b])
        blank = lp[b, :T, :U + 1, 0]
        emit = lp[b, :T, torch.arange(U), lab[b, :U]]
        prev = None
        for t in range(T):
            down = None if prev is None else prev + blank[t - 1]
            row = [lp.new_zeros(()) if down is None else down[0]]
            for u in range(1, U + 1):
                left = row[-1] + emit[t, u - 1]
                row.append(left if down is None else
                           torch.logaddexp(down[u], left))
            prev = torch.stack(row)
        losses.append(-(prev[U] + blank[T - 1, U]))
    return torch.stack(losses).mean()


@pytest.mark.parametrize("seed", [13, 14, 15, 16])
def test_rnnt_loss_f32_gradient_near_f64(seed):
    """The port's f32 RNN-T at [2, T 255, U + 1 = 65, V 32] (the card
    test's inputs) against the lattice evaluated cell by cell in f64: the
    loss within rtol 1e-6 and the logits' gradient (entries up to ~0.5)
    within atol 1e-6: the port carries the lattice in f64, so only its
    f32 log-softmax and gradient round (a few ulps of 0.5). An f32
    lattice, summed to |ll| ~ 880, misses by 2e-5-1e-4."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 255, 65, 32).astype(np.float32)
    lab = torch.from_numpy(rng.randint(1, 32, (2, 64)))
    in_len, lab_len = torch.tensor([255, 201]), torch.tensor([64, 40])
    t = torch.from_numpy(x).double().requires_grad_(True)
    want = _rnnt_f64(t, lab, in_len, lab_len)
    (g_want,) = torch.autograd.grad(want, t)
    t = torch.from_numpy(x).requires_grad_(True)
    got = TF.rnnt_loss(t, lab, in_len, lab_len)
    (g_got,) = torch.autograd.grad(got, t)
    err = float((g_got.double() - g_want).abs().max())
    print(f"seed {seed}: loss {float(got.detach())!r} against f64 "
          f"{float(want.detach())!r}, gradient max abs err {err:.3e}")
    assert float(got.detach()) == pytest.approx(float(want.detach()),
                                                rel=1e-6)
    assert err < 1e-6


def test_rnnt_and_ctc_loss_layers_equal_jax():
    B, T, U, V = 2, 9, 4, 5
    x = rand(6, B, T, U + 1, V)
    lab, _ = _labels(7, B, U, V, 1, 1)
    lens = [np.array([9, 7], np.int32), np.array([4, 2], np.int32)]
    check(paddle.nn.RNNTLoss(reduction="sum"), pt.nn.RNNTLoss(
        reduction="sum"), [x, lab] + lens)
    y = rand(8, T, B, V)
    check(paddle.nn.CTCLoss(blank=0), pt.nn.CTCLoss(blank=0),
          [y, lab] + lens)


def _hsig_args(seed, B=5, D=6, C=11):
    rng = np.random.RandomState(seed)
    return (rand(seed, B, D), rng.randint(0, C, (B, 1)).astype(np.int64),
            rand(seed + 1, C - 1, D, scale=0.5), rand(seed + 2, C - 1))


def test_hsigmoid_loss_default_and_custom_paths_equal_jax():
    x, y, w, b = _hsig_args(9)
    check(lambda a, l, u, v: JF.hsigmoid_loss(a, l, 11, u, v),
          lambda a, l, u, v: TF.hsigmoid_loss(a, l, 11, u, v), [x, y, w, b])
    rng = np.random.RandomState(10)
    table = rng.randint(-1, 10, (5, 4)).astype(np.int64)
    code = rng.randint(0, 2, (5, 4)).astype(np.int64)
    check(lambda a, l, u, t, c: JF.hsigmoid_loss(a, l, 11, u, None, t, c),
          lambda a, l, u, t, c: TF.hsigmoid_loss(a, l, 11, u, None, t, c),
          [x, y, w, table, code])
    jl, tl = paddle.nn.HSigmoidLoss(6, 11), pt.nn.HSigmoidLoss(6, 11)
    pt.params_from_paddle_tpu(
        {n: np.asarray(t._data) for n, t in jl.state_dict().items()}, tl)
    check(jl, tl, [x, y])


@pytest.mark.parametrize("reduction", ["mean", "sum", None])
def test_margin_cross_entropy_equals_jax(reduction):
    lg = np.tanh(rand(11, 4, 9)).astype(np.float32)
    lab = np.array([0, 3, 8, 3], np.int64)
    kw = dict(margin1=1.0, margin2=0.3, margin3=0.1, scale=16.0,
              return_softmax=True, reduction=reduction)
    check(lambda a, b: JF.margin_cross_entropy(a, b, **kw),
          lambda a, b: TF.margin_cross_entropy(a, b, **kw), [lg, lab],
          rtol=2e-5, atol=2e-5)


def _pos(seed, *shape):
    return (np.random.RandomState(seed).rand(*shape) * 0.8 + 0.1).astype(
        np.float32)


LOSS_CASES = [
    ("poisson_nll_loss", lambda: [rand(12, 4, 3), _pos(13, 4, 3) * 3],
     dict()),
    ("poisson_nll_loss", lambda: [_pos(14, 4, 3), _pos(15, 4, 3) * 3],
     dict(log_input=False, full=True, reduction="none")),
    ("multi_label_soft_margin_loss",
     lambda: [rand(16, 4, 5), (_pos(17, 4, 5) > 0.5).astype(np.float32),
              _pos(18, 5)], dict()),
    ("hinge_embedding_loss",
     lambda: [rand(19, 6), np.sign(rand(20, 6)).astype(np.float32)],
     dict(margin=0.5, reduction="sum")),
    ("cosine_embedding_loss",
     lambda: [rand(21, 4, 5), rand(22, 4, 5),
              np.array([1, -1, 1, -1], np.float32)], dict(margin=0.1)),
    ("multi_margin_loss",
     lambda: [rand(23, 4, 6), np.array([0, 5, 2, 2], np.int64)],
     dict(p=2, margin=0.7)),
    ("triplet_margin_loss", lambda: [rand(25, 4, 5), rand(26, 4, 5),
                                     rand(27, 4, 5)],
     dict(margin=0.5, p=1.0, swap=True)),
    ("triplet_margin_with_distance_loss",
     lambda: [rand(28, 4, 5), rand(29, 4, 5), rand(30, 4, 5)],
     dict(margin=0.3)),
    ("soft_margin_loss",
     lambda: [rand(31, 3, 4), np.sign(rand(32, 3, 4)).astype(np.float32)],
     dict()),
    ("gaussian_nll_loss", lambda: [rand(33, 4, 3), rand(34, 4, 3),
                                   _pos(35, 4, 3)],
     dict(full=True, reduction="sum")),
    ("dice_loss",
     lambda: [_pos(36, 2, 3, 4), np.random.RandomState(37).randint(
         0, 4, (2, 3, 1)).astype(np.int64)], dict()),
    ("log_loss", lambda: [_pos(38, 5, 1), (_pos(39, 5, 1) > 0.5).astype(
        np.float32)], dict()),
    ("npair_loss", lambda: [rand(40, 4, 6), rand(41, 4, 6),
                            np.array([1, 2, 1, 3], np.int64)], dict()),
    ("sigmoid_focal_loss",
     lambda: [rand(42, 4, 3), (_pos(43, 4, 3) > 0.5).astype(np.float32),
              np.array([3.0], np.float32)], dict(gamma=1.5)),
    ("sigmoid_focal_loss",
     lambda: [rand(44, 4, 3), (_pos(45, 4, 3) > 0.5).astype(np.float32)],
     dict(reduction="mean")),
    ("bilinear", lambda: [rand(46, 3, 4), rand(47, 3, 5),
                          rand(48, 2, 4, 5), rand(49, 2)], dict()),
    ("pairwise_distance", lambda: [rand(50, 3, 4), rand(51, 3, 4)],
     dict(p=3.0, keepdim=True)),
    ("maxout", lambda: [rand(52, 2, 6, 3)], dict(groups=3)),
    ("maxout", lambda: [rand(53, 2, 3, 8)], dict(groups=2, axis=-1)),
    ("thresholded_relu", lambda: [rand(54, 4, 5)], dict(threshold=0.3)),
    ("rrelu", lambda: [rand(55, 4, 5)], dict(lower=0.1, upper=0.4)),
]


@pytest.mark.parametrize("name,make,kw", LOSS_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(LOSS_CASES)])
def test_long_tail_function_equals_jax(name, make, kw):
    check(lambda *a: getattr(JF, name)(*a, **kw),
          lambda *a: getattr(TF, name)(*a, **kw), make())


def test_triplet_loss_with_a_distance_function_equals_jax():
    def jd(a, b):
        return ((a - b) ** 2).sum(-1)

    def td(a, b):
        return ((a - b) ** 2).sum(-1)

    args = [rand(56, 4, 5), rand(57, 4, 5), rand(58, 4, 5)]
    check(lambda *a: JF.triplet_margin_with_distance_loss(
        *a, distance_function=jd, swap=True),
        lambda *a: TF.triplet_margin_with_distance_loss(
            *a, distance_function=td, swap=True), args)


LAYER_CASES = [
    ("PoissonNLLLoss", dict(full=True), 2),
    ("MultiLabelSoftMarginLoss", dict(reduction="sum"), 2),
    ("HingeEmbeddingLoss", dict(margin=2.0), 2),
    ("CosineEmbeddingLoss", dict(margin=0.2), 3),
    ("MultiMarginLoss", dict(margin=0.5), 2),
    ("TripletMarginLoss", dict(p=1.0), 3),
    ("TripletMarginWithDistanceLoss", dict(margin=0.2), 3),
    ("SoftMarginLoss", dict(reduction="none"), 2),
    ("GaussianNLLLoss", dict(epsilon=1e-3), 3),
]


@pytest.mark.parametrize("name,kw,n", LAYER_CASES,
                         ids=[c[0] for c in LAYER_CASES])
def test_loss_layers_equal_jax(name, kw, n):
    arrays = {
        "PoissonNLLLoss": [_pos(60, 4, 3), _pos(61, 4, 3) * 3],
        "MultiLabelSoftMarginLoss": [rand(62, 4, 5), (_pos(63, 4, 5) > 0.5)
                                     .astype(np.float32)],
        "HingeEmbeddingLoss": [rand(64, 6), np.sign(rand(65, 6))
                               .astype(np.float32)],
        "CosineEmbeddingLoss": [rand(66, 3, 4), rand(67, 3, 4),
                                np.array([1, -1, 1], np.float32)],
        "MultiMarginLoss": [rand(68, 3, 4), np.array([1, 0, 3], np.int64)],
        "TripletMarginLoss": [rand(69, 3, 4), rand(70, 3, 4),
                              rand(71, 3, 4)],
        "TripletMarginWithDistanceLoss": [rand(72, 3, 4), rand(73, 3, 4),
                                          rand(74, 3, 4)],
        "SoftMarginLoss": [rand(75, 3, 4), np.sign(rand(76, 3, 4))
                           .astype(np.float32)],
        "GaussianNLLLoss": [rand(77, 3, 4), rand(78, 3, 4),
                            _pos(79, 3, 4)],
    }[name]
    assert len(arrays) == n
    check(getattr(paddle.nn, name)(**kw), getattr(pt.nn, name)(**kw), arrays)


def test_activation_layers_equal_jax():
    x = rand(80, 2, 4, 3, 3)
    for jl, tl in ((paddle.nn.Maxout(2), pt.nn.Maxout(2)),
                   (paddle.nn.Softmax2D(), pt.nn.Softmax2D()),
                   (paddle.nn.ThresholdedReLU(0.2, 5.0),
                    pt.nn.ThresholdedReLU(0.2, 5.0)),
                   (paddle.nn.PixelShuffle(2), pt.nn.PixelShuffle(2)),
                   (paddle.nn.PixelUnshuffle(3), pt.nn.PixelUnshuffle(3)),
                   (paddle.nn.ZeroPad2D([1, 0, 2, 1]),
                    pt.nn.ZeroPad2D([1, 0, 2, 1])),
                   (paddle.nn.Unflatten(1, [2, 2]), pt.nn.Unflatten(1, [2, 2])),
                   (paddle.nn.Unfold(2), pt.nn.Unfold(2))):
        jl.eval(), tl.eval()
        check(jl, tl, [x])
    rr_j, rr_t = paddle.nn.RReLU(0.1, 0.3), pt.nn.RReLU(0.1, 0.3)
    rr_j.eval(), rr_t.eval()
    check(rr_j, rr_t, [x])
    check(paddle.nn.Fold([4, 4], 2), pt.nn.Fold([4, 4], 2),
          [rand(81, 2, 8, 9)])
    check(paddle.nn.PairwiseDistance(), pt.nn.PairwiseDistance(),
          [rand(82, 3, 4), rand(83, 3, 4)])
    jb, tb = paddle.nn.Bilinear(3, 4, 2), pt.nn.Bilinear(3, 4, 2)
    pt.params_from_paddle_tpu(
        {n: np.asarray(t._data) for n, t in jb.state_dict().items()}, tb)
    check(jb, tb, [rand(84, 5, 3), rand(85, 5, 4)])


@pytest.mark.parametrize("name,args", [
    ("elu_", (0.5,)), ("hardtanh_", (-0.3, 0.4)), ("leaky_relu_", (0.2,)),
    ("softmax_", (1,)), ("tanh_", ()), ("thresholded_relu_", (0.1,))])
def test_inplace_activations_write_jax_s_values(name, args):
    """Each writes its out-of-place value into ``x`` and returns ``x``; a
    leaf that requires grad raises; the gradient through it is the
    out-of-place one's."""
    x = rand(86, 3, 4)
    jx = paddle.to_tensor(x)
    getattr(JF, name)(jx, *args)
    tx = torch.from_numpy(x.copy())
    assert getattr(TF, name)(tx, *args) is tx
    np.testing.assert_allclose(tx.numpy(), to_np(jx), rtol=1e-6, atol=1e-7)
    leaf = torch.from_numpy(x.copy()).requires_grad_(True)
    with pytest.raises(RuntimeError):
        getattr(TF, name)(leaf, *args)
    y = leaf * 1.0
    getattr(TF, name)(y, *args).sum().backward()
    ref = torch.from_numpy(x.copy()).requires_grad_(True)
    base = getattr(TF, name[:-1])(ref, *args)
    base.sum().backward()
    np.testing.assert_allclose(leaf.grad.numpy(), ref.grad.numpy(),
                               rtol=1e-6)


def test_class_center_sample_equals_jax():
    """Host work on numpy's global generator, as in JAX: the same draws
    from the same seed."""
    lab = np.array([3, 7, 3, 1, 9], np.int64)
    np.random.seed(5)
    jr, js = JF.class_center_sample(paddle.to_tensor(lab), 20, 8)
    np.random.seed(5)
    tr, ts = TF.class_center_sample(torch.from_numpy(lab), 20, 8)
    np.testing.assert_array_equal(tr.numpy(), to_np(jr))
    np.testing.assert_array_equal(ts.numpy(), to_np(js))


def test_sparse_attention_equals_jax():
    B, H, S, D = 2, 2, 5, 4
    q, k, v = rand(87, B, H, S, D), rand(88, B, H, S, D), rand(89, B, H, S, D)
    off = np.array([0, 2, 3, 5, 6, 8], np.int32)
    col = np.array([0, 1, 1, 0, 2, 3, 3, 4], np.int32)
    kp = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 1, 1]], bool)
    am = rand(90, B, H, S, S, scale=0.1)
    check(lambda a, b, c, o, p, m, n: JF.sparse_attention(a, b, c, o, p, m,
                                                          n),
          lambda a, b, c, o, p, m, n: TF.sparse_attention(a, b, c, o, p, m,
                                                          n),
          [q, k, v, off, col, kp, am])


def test_max_unpool_default_size_ignores_padding_unlike_torch():
    """JAX's (and the port's) default size is ``(in - 1) * stride +
    kernel``, padding ignored; torch's subtracts ``2 * padding``."""
    x = torch.from_numpy(rand(91, 1, 2, 6, 6))
    y, idx = TF.max_pool2d(x, 2, 2, return_mask=True)
    got = TF.max_unpool2d(y, idx, 2, 2, padding=1)
    assert got.shape[-2:] == (6, 6)
    assert torch.equal(got, torch.nn.functional.max_unpool2d(y, idx, 2, 2))
    with pytest.raises(RuntimeError):      # torch's 4 x 4 cannot hold them
        torch.nn.functional.max_unpool2d(y, idx, 2, 2, padding=1)


def test_random_activations_support():
    """``rrelu`` in training draws a slope a negative element in [lower,
    upper); ``gumbel_softmax`` rows sum to 1, and its hard form gives
    one-hot rows with the soft sample's gradient."""
    g = torch.Generator().manual_seed(3)
    x = -torch.rand(2000) - 0.1
    y = TF.rrelu(x, 0.1, 0.3, training=True, generator=g)
    slope = y / x
    assert float(slope.min()) >= 0.1 and float(slope.max()) < 0.3
    assert abs(float(slope.mean()) - 0.2) < 0.01
    logits = torch.from_numpy(rand(92, 6, 5)).requires_grad_(True)
    soft = TF.gumbel_softmax(logits, 0.5, generator=torch.Generator()
                             .manual_seed(4))
    torch.testing.assert_close(soft.sum(-1), torch.ones(6))
    hard = TF.gumbel_softmax(logits, 0.5, hard=True,
                             generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(hard.detach().sum(-1), torch.ones(6))
    assert torch.equal(hard.detach().argmax(-1), soft.detach().argmax(-1))
    w = torch.from_numpy(rand(93, 6, 5))
    gh, = torch.autograd.grad((hard * w).sum(), logits)
    gs, = torch.autograd.grad((soft * w).sum(), logits)
    torch.testing.assert_close(gh, gs)
