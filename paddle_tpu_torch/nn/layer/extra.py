"""The long tail of layers (``paddle_tpu/nn/layer/extra.py``): layers over
the long-tail functionals (``Bilinear`` ... ``Unflatten``), the 1-D and
3-D instance norms, the 3-D adaptive pools, max unpooling, the loss
layers (the ``_loss_layer`` family takes its options as keywords only,
``**kwargs``, as JAX's does), ``CTCLoss`` / ``RNNTLoss`` /
``HSigmoidLoss``, the public ``RNNCellBase`` and beam search.

* ``nn.RNNCellBase`` is this file's (``extra.py:332``): its
  ``get_initial_states`` gives two f32 zero states where the cell's
  ``state_shape`` is a pair, else one. The cells of :mod:`.rnn` derive
  from that file's own base, as in JAX.
* :class:`ThresholdedReLU` calls ``nn.functional.thresholded_relu``,
  which is ``long_tail``'s and takes no ``value``: its ``value`` lands
  in ``name`` and changes nothing, as in JAX.
* :func:`dynamic_decode` runs a :class:`BeamSearchDecoder` host-driven
  (``extra.py:364-442``): the first step seeds ``beam_size`` beams a row
  from ``start_token``, each later step extends every beam by every
  token (a finished beam only by ``end_token``, at no cost), keeps the
  best ``beam_size`` totals, reorders the histories and the cell's
  states by parent, and stops when every beam has finished or after
  ``max_step_num`` steps -> (ids [B, beam, T], scores [B, beam]). No
  gradient is recorded, as the JAX loop records none.
"""
from __future__ import annotations

import torch

from ... import ops
from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = [
    "Bilinear", "Unfold", "Fold", "Maxout", "PairwiseDistance",
    "Softmax2D", "ThresholdedReLU", "RReLU", "PixelShuffle",
    "PixelUnshuffle", "ChannelShuffle", "ZeroPad2D", "Unflatten",
    "InstanceNorm1D", "InstanceNorm3D", "AdaptiveAvgPool3D",
    "AdaptiveMaxPool3D", "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D",
    "PoissonNLLLoss", "MultiLabelSoftMarginLoss", "HingeEmbeddingLoss",
    "CosineEmbeddingLoss", "MultiMarginLoss", "TripletMarginLoss",
    "TripletMarginWithDistanceLoss", "SoftMarginLoss", "GaussianNLLLoss",
    "CTCLoss", "RNNTLoss", "HSigmoidLoss", "RNNCellBase",
    "BeamSearchDecoder", "dynamic_decode",
]


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr)
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self._args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        k, s, p, d = self._args
        return F.unfold(x, k, strides=s, paddings=p, dilations=d)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self._args = (output_sizes, kernel_sizes, strides, paddings,
                      dilations)

    def forward(self, x):
        o, k, s, p, d = self._args
        return F.fold(x, o, k, strides=s, paddings=p, dilations=d)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self._groups, self._axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self._groups, self._axis)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self._args = (p, epsilon, keepdim)

    def forward(self, x, y):
        p, e, k = self._args
        return F.pairwise_distance(x, y, p=p, epsilon=e, keepdim=k)


class Softmax2D(Layer):
    """Softmax over the channel axis of ``NCHW``."""

    def forward(self, x):
        return F.softmax(x, axis=-3)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, value=0.0, name=None):
        super().__init__()
        self._threshold, self._value = threshold, value

    def forward(self, x):
        return F.thresholded_relu(x, self._threshold, self._value)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None, *,
                 generator=None):
        super().__init__()
        self._lower, self._upper = lower, upper
        self.generator = generator

    def forward(self, x):
        return F.rrelu(x, self._lower, self._upper, training=self.training,
                       generator=self.generator)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self._args = (upscale_factor, data_format)

    def forward(self, x):
        return F.pixel_shuffle(x, *self._args)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self._args = (downscale_factor, data_format)

    def forward(self, x):
        return F.pixel_unshuffle(x, *self._args)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class ZeroPad2D(Layer):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__()
        self._args = (padding, data_format)

    def forward(self, x):
        return F.zeropad2d(x, *self._args)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self._axis, self._shape = axis, shape

    def forward(self, x):
        return ops.unflatten(x, self._axis, self._shape)


def _instance_norm_nd(nd):
    class _InstanceNormND(Layer):
        def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                     weight_attr=None, bias_attr=None, data_format=None,
                     name=None, *, device=None, dtype=None, generator=None):
            super().__init__(dtype=dtype, device=device, generator=generator)
            self._epsilon = epsilon
            self.weight = None if weight_attr is False else \
                self.create_parameter([num_features], attr=weight_attr,
                                      default_initializer=I.Constant(1.0))
            self.bias = None if bias_attr is False else \
                self.create_parameter([num_features], attr=bias_attr,
                                      is_bias=True)

        def forward(self, x):
            return F.instance_norm(x, weight=self.weight, bias=self.bias,
                                   eps=self._epsilon)

    _InstanceNormND.__name__ = _InstanceNormND.__qualname__ = \
        f"InstanceNorm{nd}D"
    return _InstanceNormND


InstanceNorm1D = _instance_norm_nd(1)
InstanceNorm3D = _instance_norm_nd(3)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__()
        self._args = (output_size, data_format)

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, *self._args)


class AdaptiveMaxPool3D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self._output_size, self._return_mask = output_size, return_mask

    def forward(self, x):
        return F.adaptive_max_pool3d(x, self._output_size,
                                     self._return_mask)


class _MaxUnPoolND(Layer):
    _nd = 0

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format=None, output_size=None, name=None):
        super().__init__()
        self._args = (kernel_size, stride, padding, output_size)

    def forward(self, x, indices):
        k, s, p, o = self._args
        return getattr(F, f"max_unpool{self._nd}d")(
            x, indices, k, stride=s, padding=p, output_size=o)


class MaxUnPool1D(_MaxUnPoolND):
    _nd = 1


class MaxUnPool2D(_MaxUnPoolND):
    _nd = 2


class MaxUnPool3D(_MaxUnPoolND):
    _nd = 3


def _loss_layer(name, fn, arg_names, n_inputs=2):
    class _LossLayer(Layer):
        def __init__(self, **kwargs):
            super().__init__()
            self._kwargs = {k: kwargs.get(k, v) for k, v in arg_names}

        def forward(self, *inputs):
            return fn(*inputs[:n_inputs], **self._kwargs)

    _LossLayer.__name__ = _LossLayer.__qualname__ = name
    _LossLayer.__doc__ = (f"``{name}(**kwargs)``: ``{fn.__name__}`` with "
                          f"the options {dict(arg_names)}.")
    return _LossLayer


PoissonNLLLoss = _loss_layer(
    "PoissonNLLLoss", F.poisson_nll_loss,
    [("log_input", True), ("full", False), ("epsilon", 1e-8),
     ("reduction", "mean")])
MultiLabelSoftMarginLoss = _loss_layer(
    "MultiLabelSoftMarginLoss", F.multi_label_soft_margin_loss,
    [("weight", None), ("reduction", "mean")])
HingeEmbeddingLoss = _loss_layer(
    "HingeEmbeddingLoss", F.hinge_embedding_loss,
    [("margin", 1.0), ("reduction", "mean")])
CosineEmbeddingLoss = _loss_layer(
    "CosineEmbeddingLoss", F.cosine_embedding_loss,
    [("margin", 0.0), ("reduction", "mean")], n_inputs=3)
MultiMarginLoss = _loss_layer(
    "MultiMarginLoss", F.multi_margin_loss,
    [("p", 1), ("margin", 1.0), ("weight", None), ("reduction", "mean")])
TripletMarginLoss = _loss_layer(
    "TripletMarginLoss", F.triplet_margin_loss,
    [("margin", 1.0), ("p", 2.0), ("epsilon", 1e-6), ("swap", False),
     ("reduction", "mean")], n_inputs=3)
TripletMarginWithDistanceLoss = _loss_layer(
    "TripletMarginWithDistanceLoss", F.triplet_margin_with_distance_loss,
    [("distance_function", None), ("margin", 1.0), ("swap", False),
     ("reduction", "mean")], n_inputs=3)
SoftMarginLoss = _loss_layer(
    "SoftMarginLoss", F.soft_margin_loss, [("reduction", "mean")])
GaussianNLLLoss = _loss_layer(
    "GaussianNLLLoss", F.gaussian_nll_loss,
    [("full", False), ("epsilon", 1e-6), ("reduction", "mean")],
    n_inputs=3)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self._blank, self._reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          blank=self._blank, reduction=self._reduction,
                          norm_by_times=norm_by_times)


class RNNTLoss(Layer):
    def __init__(self, blank=0, fastemit_lambda=0.001, reduction="mean",
                 name=None):
        super().__init__()
        self._args = (blank, fastemit_lambda, reduction)

    def forward(self, input, label, input_lengths, label_lengths):
        b, f, r = self._args
        return F.rnnt_loss(input, label, input_lengths, label_lengths,
                           blank=b, fastemit_lambda=f, reduction=r)


class HSigmoidLoss(Layer):
    """The hierarchical sigmoid over the default complete binary tree:
    ``weight`` [num_classes - 1, feature_size], ``bias`` [num_classes -
    1]."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        if is_custom:
            raise NotImplementedError(
                "custom-tree HSigmoidLoss is not implemented")
        self._num_classes = num_classes
        self.weight = self.create_parameter(
            [num_classes - 1, feature_size], attr=weight_attr)
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_classes - 1], attr=bias_attr, is_bias=True)

    def forward(self, input, label, path_table=None, path_code=None):
        return F.hsigmoid_loss(input, label, self._num_classes,
                               self.weight, self.bias,
                               path_table=path_table, path_code=path_code)


# ------------------------------------------------------ seq2seq decoding
class RNNCellBase(Layer):
    """The public cell contract (``extra.py:332-347``)."""

    def get_initial_states(self, batch_ref, shape=None, dtype="float32",
                           init_value=0.0, batch_dim_idx=0):
        batch = batch_ref.shape[batch_dim_idx]

        def mk():
            return torch.full((batch, self.hidden_size), init_value,
                              dtype=torch.float32, device=batch_ref.device)

        state_shape = getattr(self, "state_shape", None)
        if isinstance(state_shape, (list, tuple)) and len(state_shape) == 2:
            return (mk(), mk())
        return mk()


class BeamSearchDecoder:
    """Beam search over an RNN cell with an optional token embedding and
    output projection; run by :func:`dynamic_decode`."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def initialize(self, initial_cell_states):
        return initial_cell_states

    def _logits(self, out):
        return self.output_fn(out) if self.output_fn is not None else out


def _map_state(state, fn):
    return tuple(fn(s) for s in state) if isinstance(state, (list, tuple)) \
        else fn(state)


@torch.no_grad()
def dynamic_decode(decoder, inits=None, max_step_num=100, **kwargs):
    """Run ``decoder`` from the cell states ``inits`` (the module's doc)."""
    cell, K = decoder.cell, decoder.beam_size
    end = decoder.end_token
    state = inits
    leaf = state[0] if isinstance(state, (list, tuple)) else state
    B, dev = leaf.shape[0], leaf.device

    def emb(tok):
        return decoder.embedding_fn(tok) if decoder.embedding_fn is not None \
            else tok

    tok0 = torch.full((B,), decoder.start_token, dtype=torch.int64,
                      device=dev)
    out, state = cell(emb(tok0), state)
    logp0 = torch.log_softmax(decoder._logits(out), -1)
    V = logp0.shape[-1]
    beam_scores, ids = torch.topk(logp0, K)                 # [B, K]
    beam_ids = [ids]
    finished = ids == end
    state = _map_state(state, lambda s: s.repeat_interleave(K, 0))
    rows = torch.arange(B, device=dev)[:, None]
    cur = ids.reshape(-1)
    for _ in range(max_step_num - 1):
        if bool(finished.all()):
            break
        out, new_state = cell(emb(cur), state)
        logp = torch.log_softmax(decoder._logits(out), -1).reshape(B, K, V)
        fin = finished[:, :, None]
        step = torch.where(fin, -1e9, logp)
        step[:, :, end] = torch.where(fin[:, :, 0], 0.0, step[:, :, end])
        total = beam_scores[:, :, None] + step
        beam_scores, flat = torch.topk(total.reshape(B, K * V), K)
        parent, tok = flat // V, flat % V
        beam_ids = [h.gather(1, parent) for h in beam_ids] + [tok]
        take = (rows * K + parent).reshape(-1)
        state = _map_state(new_state, lambda s: s.index_select(0, take))
        finished = finished.gather(1, parent) | (tok == end)
        cur = tok.reshape(-1)
    return torch.stack(beam_ids, -1), beam_scores
