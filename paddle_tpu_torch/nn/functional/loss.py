"""Losses (``paddle_tpu/nn/functional/loss.py:21-193``; reference:
python/paddle/nn/functional/loss.py). Each casts its floating inputs under
``auto_cast`` by its JAX op name (all but ``square_error_cost`` are on the
black list, so they compute in f32) and is the JAX expression written with
torch ops: the same clips, the same order of the weighted mean's sums.
:func:`cross_entropy` is the one every model of the port calls."""
from __future__ import annotations

import torch

from .common import _amp_cast

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "mse_loss", "l1_loss",
    "nll_loss", "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "smooth_l1_loss", "kl_div", "margin_ranking_loss", "square_error_cost",
]


def _cast(op_name, *tensors):
    """``tensors`` with the floating ones cast by ``op_name`` in one
    ``amp_cast`` call; labels of an integer type and absent (None)
    arguments pass as they are."""
    floats = [t for t in tensors if t is not None and t.is_floating_point()]
    cast = iter(_amp_cast(op_name, *floats))
    return tuple(next(cast) if t is not None and t.is_floating_point()
                 else t for t in tensors)


def _reduce(val, reduction):
    if reduction == "mean":
        return val.mean()
    if reduction == "sum":
        return val.sum()
    return val


def _pick(logp, label, axis):
    """``logp`` at the class ``label`` names along ``axis`` (``label``
    has ``logp``'s shape without that axis)."""
    return logp.gather(axis, label.unsqueeze(axis)).squeeze(axis)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross-entropy over ``axis`` of ``input`` (``loss.py:
    29-93``), in f32: hard labels (``ignore_index`` entries contribute 0
    and, under ``"mean"``, leave the count, or the sum of their class
    ``weight``s) or ``soft_label`` distributions; ``label_smoothing``
    mixes in the uniform distribution; ``use_softmax=False`` takes
    ``input`` as probabilities. ``reduction`` is ``"mean"``, ``"sum"`` or
    ``"none"``."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction {reduction!r}: mean, sum or none")
    input, label, weight = _cast("cross_entropy", input, label, weight)
    axis = axis % input.dim()
    n_classes = input.shape[axis]
    lf = input.float()
    logp = (torch.log_softmax(lf, dim=axis) if use_softmax
            else torch.log(torch.clamp(lf, 1e-15, 1.0)))
    if soft_label:
        soft = label.float()
        if label_smoothing > 0:
            soft = soft * (1 - label_smoothing) + label_smoothing / n_classes
        return _reduce(-(soft * logp).sum(dim=axis), reduction)
    if label.dim() == logp.dim():            # [N, 1] style labels
        label = label.squeeze(axis)
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    picked = _pick(logp, safe, axis)
    if label_smoothing > 0:
        picked = (1 - label_smoothing) * picked \
            + label_smoothing * logp.mean(dim=axis)
    loss = -picked
    if weight is not None:
        wc = weight.float()[safe]
        loss = loss * wc
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        if weight is not None:
            denom = torch.where(valid, wc, torch.zeros_like(wc)).sum()
        else:
            denom = valid.sum().float()
        return loss.sum() / torch.clamp_min(denom, 1e-12)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """The unreduced :func:`cross_entropy` with ``axis`` kept as size 1;
    with ``return_softmax`` also the softmax of ``logits``."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        from .activation import softmax
        return loss, softmax(logits, axis=axis)
    return loss


def mse_loss(input, label, reduction="mean", name=None):
    input, label = _cast("mse_loss", input, label)
    d = (input - label).float()
    return _reduce(d * d, reduction)


def square_error_cost(input, label):
    input, label = _cast("square_error_cost", input, label)
    d = input - label
    return d * d


def l1_loss(input, label, reduction="mean", name=None):
    input, label = _cast("l1_loss", input, label)
    return _reduce((input - label).abs(), reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """Negative log-likelihood of ``[N, C]`` log-probabilities at ``[N]``
    labels (``loss.py:117-135``)."""
    input, label, weight = _cast("nll_loss", input, label, weight)
    valid = label != ignore_index
    li = torch.where(valid, label, torch.zeros_like(label)).long()
    loss = -_pick(input, li, 1)
    if weight is not None:
        loss = loss * weight[li]
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        denom = (weight[li] * valid).sum() if weight is not None \
            else valid.sum()
        return loss.sum() / torch.clamp_min(denom.float(), 1e-12)
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    input, label, weight = _cast("bce", input, label, weight)
    p = torch.clamp(input.float(), 1e-12, 1 - 1e-12)
    loss = -(label * torch.log(p) + (1 - label) * torch.log1p(-p))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """``max(z, 0) - z y + log(1 + exp(-|z|))``; with ``pos_weight`` the
    positive term reweighted through ``log_sigmoid`` (``loss.py:
    151-174``)."""
    logit, label, weight, pos_weight = _cast(
        "bce_with_logits", logit, label, weight, pos_weight)
    z, y = logit.float(), label.float()
    loss = torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-z.abs()))
    if pos_weight is not None:
        loss = -(pos_weight * y * torch.nn.functional.logsigmoid(z)
                 + (1 - y) * torch.nn.functional.logsigmoid(-z))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    input, label = _cast("smooth_l1", input, label)
    d = (input - label).abs()
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", name=None):
    """``label * (log(label) - input)`` with ``input`` log-probabilities;
    ``"batchmean"`` divides the sum by the batch."""
    input, label = _cast("kl_div", input, label)
    loss = label * (torch.log(torch.clamp_min(label, 1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    input, other, label = _cast("margin_ranking", input, other, label)
    loss = torch.clamp_min(-label * (input - other) + margin, 0.0)
    return _reduce(loss, reduction)
