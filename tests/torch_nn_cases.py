"""The cases of the ``nn`` sweep: every functional and layer the port's
``nn`` slice added, each called on CPU tensors and on the card's with
the same numpy-made inputs. This file imports neither JAX nor the JAX
package: ``chip_smoke.py``'s phase 27a and the card test run it where
there is no JAX.

A case is ``(id, call, makers)``: ``call(pt, *tensors)`` builds whatever
layer it needs on the current device from a fixed seed and returns its
output(s); ``makers`` make its numpy inputs. :func:`run` calls a case on
one device and returns its output leaves and the gradients of its
floating inputs and of its layer's parameters under one fixed
cotangent."""
import numpy as np
import torch

RTOL, ATOL = 1e-4, 1e-5      # f32, TF32 off


def r(*shape, scale=1.0, shift=0.0, seed=0):
    def make():
        rng = np.random.RandomState(seed + len(shape))
        return (rng.randn(*shape) * scale + shift).astype(np.float32)
    return make


def pos(*shape, seed=0):
    def make():
        rng = np.random.RandomState(seed + 7)
        return (rng.rand(*shape) * 0.8 + 0.1).astype(np.float32)
    return make


def ints(lo, hi, *shape, seed=0):
    def make():
        return np.random.RandomState(seed + 3).randint(lo, hi, shape)
    return make


def const(a):
    return lambda: np.asarray(a)


def _layer(pt, build, device):
    """The layer ``build(pt.nn)`` makes on the CPU from seed 0 (each
    device has a generator of its own), moved to ``device``."""
    pt.set_device("cpu")
    pt.seed(0)
    layer = build(pt.nn).to(device)
    pt.set_device(device)
    return layer


def L(build):
    """A case call that builds a layer, then applies it to the inputs."""
    def call(pt, *t):
        layer = _layer(pt, build, t[0].device.type)
        call.layer = layer
        return layer(*t)
    return call


def F(name, *args, **kw):
    def call(pt, *t):
        return getattr(pt.nn.functional, name)(*t, *args, **kw)
    return call


CASES = [
    # convolutions
    ("conv1d", F("conv1d", padding=[1, 2], stride=2),
     [r(2, 4, 11), r(6, 4, 3, scale=0.3), r(6)]),
    ("conv1d depthwise", F("conv1d", groups=8),
     [r(2, 8, 40), r(8, 1, 32, scale=0.3)]),
    ("conv3d", F("conv3d", padding=1, stride=2),
     [r(1, 2, 5, 6, 7), r(3, 2, 3, 3, 3, scale=0.3)]),
    ("conv1d_transpose", F("conv1d_transpose", stride=2, output_padding=1),
     [r(2, 4, 7), r(4, 3, 3, scale=0.3)]),
    ("conv2d_transpose", F("conv2d_transpose", stride=2, padding=[1, 0]),
     [r(2, 4, 5, 6), r(4, 3, 3, 3, scale=0.3), r(3)]),
    ("conv3d_transpose", F("conv3d_transpose", stride=2),
     [r(1, 2, 3, 4, 3), r(2, 3, 2, 2, 2, scale=0.3)]),
    # pools and unpools
    ("max_pool1d", F("max_pool1d", 3, 2, 1), [r(2, 3, 11)]),
    ("max_pool3d", F("max_pool3d", 2, 2, 1), [r(1, 2, 5, 6, 7)]),
    ("avg_pool1d", F("avg_pool1d", 3, 2, 1), [r(2, 3, 11)]),
    ("avg_pool3d", F("avg_pool3d", 3, 2, 1, ceil_mode=True),
     [r(1, 2, 5, 6, 7)]),
    ("adaptive_avg_pool1d", F("adaptive_avg_pool1d", 4), [r(2, 3, 10)]),
    ("adaptive_max_pool1d", F("adaptive_max_pool1d", 3), [r(2, 3, 10)]),
    ("adaptive_max_pool2d", F("adaptive_max_pool2d", [4, 3]),
     [r(2, 3, 9, 7)]),
    ("adaptive_avg_pool3d", F("adaptive_avg_pool3d", [2, 3, 4]),
     [r(1, 2, 5, 6, 7)]),
    ("adaptive_max_pool3d", F("adaptive_max_pool3d", [2, 3, 2]),
     [r(1, 2, 5, 6, 7)]),
    ("max_unpool2d", lambda pt, x: pt.nn.functional.max_unpool2d(
        *pt.nn.functional.max_pool2d(x, 2, 2, return_mask=True), 2, 2),
     [r(2, 3, 8, 6)]),
    ("max_unpool1d", lambda pt, x: pt.nn.functional.max_unpool1d(
        *pt.nn.functional.max_pool1d(x, 2, return_mask=True), 2),
     [r(2, 3, 10)]),
    ("max_unpool3d", lambda pt, x: pt.nn.functional.max_unpool3d(
        *pt.nn.functional.max_pool3d(x, 2, return_mask=True), 2),
     [r(1, 2, 4, 6, 4)]),
    # padding, resizing, sampling
    ("pad reflect", F("pad", [1, 2, 3, 0], mode="reflect"),
     [r(2, 3, 5, 6)]),
    ("pad circular", F("pad", [3, 1, 2, 2], mode="circular"),
     [r(2, 3, 5, 6)]),
    ("pad replicate 3d", F("pad", [1, 0, 2, 1, 0, 2], mode="replicate",
                           data_format="NCDHW"), [r(1, 2, 3, 4, 5)]),
    ("pad NCL", F("pad", [15, 16], data_format="NCL"), [r(2, 6, 16)]),
    ("zeropad2d", F("zeropad2d", [1, 2, 0, 3]), [r(1, 2, 3, 4)]),
    ("interpolate nearest", F("interpolate", size=[10, 14]),
     [r(2, 3, 5, 7)]),
    ("interpolate bilinear", F("interpolate", scale_factor=2,
                               mode="bilinear"), [r(2, 3, 5, 7)]),
    ("interpolate bicubic down", F("interpolate", size=[4, 4],
                                   mode="bicubic"), [r(2, 3, 11, 9)]),
    ("upsample trilinear", F("upsample", scale_factor=[2, 1.5, 1],
                             mode="trilinear", data_format="NCDHW"),
     [r(1, 2, 3, 4, 5)]),
    ("grid_sample", F("grid_sample", padding_mode="border",
                      align_corners=False),
     [r(2, 3, 5, 6), r(2, 4, 7, 2, scale=0.7)]),
    ("affine_grid", F("affine_grid", [2, 3, 4, 5]), [r(2, 2, 3)]),
    ("unfold", F("unfold", [2, 3], strides=[2, 1], paddings=1),
     [r(2, 3, 7, 8)]),
    ("fold", F("fold", [4, 4], 2), [r(2, 8, 9)]),
    ("pixel_shuffle", F("pixel_shuffle", 2), [r(2, 8, 3, 4)]),
    ("pixel_unshuffle", F("pixel_unshuffle", 2), [r(2, 2, 6, 4)]),
    ("temporal_shift", F("temporal_shift", 2, 0.25), [r(4, 8, 3, 4)]),
    ("cosine_similarity", F("cosine_similarity"), [r(4, 6), r(4, 6,
                                                              seed=1)]),
    ("label_smooth", F("label_smooth", epsilon=0.2),
     [const(np.eye(5, dtype=np.float32)[[0, 3, 1]])]),
    # norms
    ("layer_norm", lambda pt, x, w, b: pt.nn.functional.layer_norm(
        x, [4, 16], w, b),
     [r(3, 5, 4, 16), r(4, 16, shift=1.0), r(4, 16, seed=2)]),
    ("group_norm", F("group_norm", 3), [r(2, 6, 4, 5)]),
    ("instance_norm", F("instance_norm"), [r(2, 3, 5, 4)]),
    ("normalize", F("normalize", p=3, axis=0), [r(3, 5, 4)]),
    ("local_response_norm", F("local_response_norm", 3), [r(2, 7, 3, 3)]),
    # activations
    ("maxout", F("maxout", 3), [r(2, 6, 3)]),
    ("thresholded_relu", F("thresholded_relu", 0.3), [r(4, 5)]),
    ("rrelu", F("rrelu", 0.1, 0.4), [r(4, 5)]),
    ("elu_", lambda pt, x: pt.nn.functional.elu_(x * 1.0, 0.5), [r(3, 4)]),
    ("hardtanh_", lambda pt, x: pt.nn.functional.hardtanh_(x * 1.0),
     [r(3, 4)]),
    ("leaky_relu_", lambda pt, x: pt.nn.functional.leaky_relu_(x * 1.0),
     [r(3, 4)]),
    ("softmax_", lambda pt, x: pt.nn.functional.softmax_(x * 1.0),
     [r(3, 4)]),
    ("tanh_", lambda pt, x: pt.nn.functional.tanh_(x * 1.0), [r(3, 4)]),
    ("thresholded_relu_", lambda pt, x: pt.nn.functional
     .thresholded_relu_(x * 1.0), [r(3, 4)]),
    # losses
    ("ctc_loss", F("ctc_loss"), [r(64, 2, 7), ints(1, 7, 2, 16),
                                 const(np.array([64, 50])),
                                 const(np.array([16, 9]))]),
    ("rnnt_loss", F("rnnt_loss"), [r(2, 40, 17, 6), ints(1, 6, 2, 16),
                                   const(np.array([40, 31])),
                                   const(np.array([16, 10]))]),
    ("hsigmoid_loss", lambda pt, x, y, w, b: pt.nn.functional
     .hsigmoid_loss(x, y, 11, w, b),
     [r(5, 6), ints(0, 11, 5, 1), r(10, 6, scale=0.5), r(10)]),
    ("margin_cross_entropy", F("margin_cross_entropy", margin2=0.3,
                               scale=16.0, return_softmax=True),
     [lambda: np.tanh(r(4, 9)()), const(np.array([0, 3, 8, 3]))]),
    ("poisson_nll_loss", F("poisson_nll_loss"), [r(4, 3), pos(4, 3)]),
    ("multi_label_soft_margin_loss", F("multi_label_soft_margin_loss"),
     [r(4, 5), lambda: (pos(4, 5)() > 0.5).astype(np.float32)]),
    ("hinge_embedding_loss", F("hinge_embedding_loss"),
     [r(6), lambda: np.sign(r(6, seed=4)())]),
    ("cosine_embedding_loss", F("cosine_embedding_loss"),
     [r(4, 5), r(4, 5, seed=1), const(np.array([1.0, -1, 1, -1],
                                               np.float32))]),
    ("multi_margin_loss", F("multi_margin_loss", p=2),
     [r(4, 6), const(np.array([0, 5, 2, 2]))]),
    ("triplet_margin_loss", F("triplet_margin_loss", swap=True),
     [r(4, 5), r(4, 5, seed=1), r(4, 5, seed=2)]),
    ("triplet_margin_with_distance_loss",
     F("triplet_margin_with_distance_loss"),
     [r(4, 5), r(4, 5, seed=1), r(4, 5, seed=2)]),
    ("soft_margin_loss", F("soft_margin_loss"),
     [r(3, 4), lambda: np.sign(r(3, 4, seed=5)())]),
    ("gaussian_nll_loss", F("gaussian_nll_loss", full=True),
     [r(4, 3), r(4, 3, seed=1), pos(4, 3)]),
    ("dice_loss", F("dice_loss"), [pos(2, 3, 4), ints(0, 4, 2, 3, 1)]),
    ("log_loss", F("log_loss"), [pos(5, 1), lambda: (
        pos(5, 1, seed=2)() > 0.5).astype(np.float32)]),
    ("npair_loss", F("npair_loss"), [r(4, 6), r(4, 6, seed=1),
                                     const(np.array([1, 2, 1, 3]))]),
    ("sigmoid_focal_loss", F("sigmoid_focal_loss"),
     [r(4, 3), lambda: (pos(4, 3)() > 0.5).astype(np.float32)]),
    ("bilinear", F("bilinear"), [r(3, 4), r(3, 5), r(2, 4, 5), r(2)]),
    ("pairwise_distance", F("pairwise_distance", p=3.0),
     [r(3, 4), r(3, 4, seed=1)]),
    ("sparse_attention", lambda pt, q, k, v: pt.nn.functional
     .sparse_attention(q, k, v, np.array([0, 2, 3, 5, 6, 8]),
                       np.array([0, 1, 1, 0, 2, 3, 3, 4])),
     [r(2, 2, 5, 4), r(2, 2, 5, 4, seed=1), r(2, 2, 5, 4, seed=2)]),
    ("sequence_mask", F("sequence_mask", 7), [const(np.array([[3, 0],
                                                              [5, 1]]))]),
    ("gather_tree", F("gather_tree"), [ints(0, 9, 5, 2, 3),
                                       ints(0, 3, 5, 2, 3)]),
    ("one_hot", F("one_hot", 6), [ints(0, 6, 4)]),
    # layers with parameters
    ("Conv1D", L(lambda nn: nn.Conv1D(4, 6, 3, padding=1)), [r(2, 4, 9)]),
    ("Conv3D", L(lambda nn: nn.Conv3D(2, 3, 2)), [r(1, 2, 4, 5, 3)]),
    ("Conv1DTranspose", L(lambda nn: nn.Conv1DTranspose(4, 6, 3, 2)),
     [r(2, 4, 5)]),
    ("Conv2DTranspose", L(lambda nn: nn.Conv2DTranspose(4, 2, 3, 2,
                                                        groups=2)),
     [r(2, 4, 5, 5)]),
    ("Conv3DTranspose", L(lambda nn: nn.Conv3DTranspose(2, 3, 2, 2)),
     [r(1, 2, 3, 3, 3)]),
    ("GroupNorm", L(lambda nn: nn.GroupNorm(2, 6)), [r(2, 6, 3, 4)]),
    ("InstanceNorm1D", L(lambda nn: nn.InstanceNorm1D(4)), [r(2, 4, 7)]),
    ("InstanceNorm2D", L(lambda nn: nn.InstanceNorm2D(4)), [r(2, 4, 3, 5)]),
    ("InstanceNorm3D", L(lambda nn: nn.InstanceNorm3D(3)),
     [r(2, 3, 2, 3, 4)]),
    ("BatchNorm3D", L(lambda nn: nn.BatchNorm3D(3)), [r(2, 3, 4, 3, 2)]),
    ("SyncBatchNorm", L(lambda nn: nn.SyncBatchNorm(3)), [r(4, 3, 5, 2)]),
    ("LocalResponseNorm", L(lambda nn: nn.LocalResponseNorm(3)),
     [r(2, 5, 3, 3)]),
    ("SimpleRNNCell", L(lambda nn: nn.SimpleRNNCell(5, 6)), [r(3, 5)]),
    ("LSTMCell", L(lambda nn: nn.LSTMCell(5, 6)), [r(3, 5)]),
    ("GRUCell", L(lambda nn: nn.GRUCell(5, 6)), [r(3, 5)]),
    ("RNN", lambda pt, x, n: L(lambda nn: nn.RNN(nn.GRUCell(4, 5),
                                                 is_reverse=True))(
        pt, x, None, n), [r(3, 7, 4), const(np.array([7, 4, 1]))]),
    ("BiRNN", lambda pt, x, n: L(lambda nn: nn.BiRNN(
        nn.LSTMCell(4, 5), nn.LSTMCell(4, 5)))(pt, x, None, n),
     [r(2, 6, 4), const(np.array([6, 2]))]),
    ("SimpleRNN", L(lambda nn: nn.SimpleRNN(4, 5, num_layers=2)),
     [r(3, 6, 4)]),
    ("LSTM", lambda pt, x, n: L(lambda nn: nn.LSTM(
        4, 5, num_layers=2, direction="bidirect"))(pt, x, None, n),
     [r(3, 6, 4), const(np.array([6, 3, 5]))]),
    ("GRU", L(lambda nn: nn.GRU(4, 5, time_major=True)), [r(6, 3, 4)]),
    ("Bilinear", L(lambda nn: nn.Bilinear(3, 4, 2)), [r(5, 3), r(5, 4)]),
    ("HSigmoidLoss", L(lambda nn: nn.HSigmoidLoss(6, 11)),
     [r(5, 6), ints(0, 11, 5, 1)]),
    ("weight_norm", lambda pt, x: pt.nn.utils.weight_norm(
        _layer(pt, lambda nn: nn.Linear(4, 3), x.device.type))(x),
     [r(5, 4)]),
    ("spectral_norm", lambda pt, x: pt.nn.utils.spectral_norm(
        _layer(pt, lambda nn: nn.Linear(4, 3), x.device.type))(x),
     [r(5, 4)]),
    # layers without parameters
    ("Pad2D", L(lambda nn: nn.Pad2D([1, 0, 2, 1], mode="reflect")),
     [r(2, 3, 5, 6)]),
    ("Upsample", L(lambda nn: nn.Upsample(size=[3, 4], mode="bicubic")),
     [r(2, 3, 5, 6)]),
    ("UpsamplingBilinear2D", L(lambda nn: nn.UpsamplingBilinear2D(
        scale_factor=2)), [r(2, 3, 5, 6)]),
    ("UpsamplingNearest2D", L(lambda nn: nn.UpsamplingNearest2D(
        size=[7, 9])), [r(2, 3, 5, 6)]),
    ("CosineSimilarity", L(lambda nn: nn.CosineSimilarity(axis=-1)),
     [r(3, 4), r(3, 4, seed=1)]),
    ("Maxout", L(lambda nn: nn.Maxout(2)), [r(2, 4, 3, 3)]),
    ("Softmax2D", L(lambda nn: nn.Softmax2D()), [r(2, 4, 3, 3)]),
    ("ThresholdedReLU", L(lambda nn: nn.ThresholdedReLU(0.2)),
     [r(2, 4, 3)]),
    ("PixelShuffle", L(lambda nn: nn.PixelShuffle(2)), [r(2, 4, 3, 3)]),
    ("Unflatten", L(lambda nn: nn.Unflatten(1, [2, 2])), [r(2, 4, 3)]),
    ("Fold", L(lambda nn: nn.Fold([4, 4], 2)), [r(2, 8, 9)]),
    ("PairwiseDistance", L(lambda nn: nn.PairwiseDistance()),
     [r(3, 4), r(3, 4, seed=1)]),
    ("MaxPool1D", L(lambda nn: nn.MaxPool1D(3, 2)), [r(2, 3, 11)]),
    ("AvgPool3D", L(lambda nn: nn.AvgPool3D(2)), [r(1, 2, 4, 4, 4)]),
    ("AdaptiveMaxPool3D", L(lambda nn: nn.AdaptiveMaxPool3D(2)),
     [r(1, 2, 4, 5, 4)]),
    ("CTCLoss", L(lambda nn: nn.CTCLoss()),
     [r(30, 2, 5), ints(1, 5, 2, 4), const(np.array([30, 25])),
      const(np.array([4, 3]))]),
    ("RNNTLoss", L(lambda nn: nn.RNNTLoss(reduction="sum")),
     [r(2, 9, 5, 5), ints(1, 5, 2, 4), const(np.array([9, 7])),
      const(np.array([4, 2]))]),
    ("TripletMarginLoss", L(lambda nn: nn.TripletMarginLoss(p=1.0)),
     [r(3, 4), r(3, 4, seed=1), r(3, 4, seed=2)]),
    ("GaussianNLLLoss", L(lambda nn: nn.GaussianNLLLoss()),
     [r(3, 4), r(3, 4, seed=1), pos(3, 4)]),
]


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _leaves(o)]
    return [out]


def run(pt, case, device):
    """-> (output leaves, gradients, the devices the outputs lay on) of
    ``case`` on ``device``, the tensors copied to the host: the floating
    inputs' gradients and the layer's parameters' under a cotangent from
    numpy seed 1."""
    _, call, makers = case
    arrays = [m() for m in makers]
    ins = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        if t.is_floating_point():
            t.requires_grad_(True)
        ins.append(t)
    pt.set_device(device)
    out = _leaves(call(pt, *ins))
    layer = getattr(call, "layer", None)
    params = list(layer.parameters()) if layer is not None else []
    diff = [o for o in out if o.requires_grad]
    targets = [t for t in ins if t.requires_grad] + params
    grads = []
    if diff and targets:
        rng = np.random.RandomState(1)
        cots = [torch.from_numpy(np.asarray(rng.randn(*o.shape),
                                            np.float32)).to(device)
                .to(o.dtype) for o in diff]
        grads = torch.autograd.grad(diff, targets, cots, allow_unused=True)
    host = [o.detach().cpu() for o in out]
    return (host, [None if g is None else g.detach().cpu() for g in grads],
            [o.device.type for o in out])
