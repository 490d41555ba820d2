"""paddle_tpu_torch.metric, after ``paddle_tpu/metric/__init__.py``
(reference: python/paddle/metric/metrics.py). The metrics compute on host
numpy exactly as the JAX package does (``np.argsort(-p)`` for top-k), so
ties break the same way; tensors are read to the host first."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self.__class__.__name__.lower()

    def compute(self, pred, label, *args):
        return pred, label


class Accuracy(Metric):
    """Top-k accuracy (reference: metrics.py Accuracy)."""

    def __init__(self, topk=(1,), name=None):
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label, *args):
        p = _np(pred)
        l = _np(label).reshape(-1)
        order = np.argsort(-p, axis=-1)[:, :self.maxk]
        correct = order == l[:, None]
        return correct

    def update(self, correct):
        correct = _np(correct)
        res = []
        for i, k in enumerate(self.topk):
            c = correct[:, :k].sum()
            self.total[i] += c
            self.count[i] += correct.shape[0]
            res.append(c / correct.shape[0])
        return res[0] if len(res) == 1 else res

    def accumulate(self):
        out = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return out[0] if len(out) == 1 else out

    def name(self):
        return self._name


class Precision(Metric):
    def __init__(self, name=None):
        self._name = name or "precision"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).reshape(-1)
        l = _np(labels).reshape(-1).astype(bool)
        self.tp += int((p & l).sum())
        self.fp += int((p & ~l).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name=None):
        self._name = name or "recall"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).reshape(-1)
        l = _np(labels).reshape(-1).astype(bool)
        self.tp += int((p & l).sum())
        self.fn += int((~p & l).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC via threshold buckets (reference: metrics.py Auc)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        self.num_thresholds = num_thresholds
        self._name = name or "auc"
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]
        p = p.reshape(-1)
        l = _np(labels).reshape(-1)
        idx = np.clip((p * self.num_thresholds).astype(int), 0,
                      self.num_thresholds)
        for i, li in zip(idx, l):
            if li:
                self._stat_pos[i] += 1
            else:
                self._stat_neg[i] += 1

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if not tot_pos or not tot_neg:
            return 0.0
        # integrate over descending thresholds
        pos = np.cumsum(self._stat_pos[::-1])
        neg = np.cumsum(self._stat_neg[::-1])
        tpr = pos / tot_pos
        fpr = neg / tot_neg
        trapz = getattr(np, 'trapezoid', None) or np.trapz
        return float(trapz(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1):
    """Functional top-k accuracy (paddle.metric.accuracy)."""
    p = _np(input)
    l = _np(label).reshape(-1)
    order = np.argsort(-p, axis=-1)[:, :k]
    correct = (order == l[:, None]).any(axis=1).mean()
    device = input.device if isinstance(input, torch.Tensor) else "cpu"
    return torch.tensor(correct, dtype=torch.float32, device=device)
