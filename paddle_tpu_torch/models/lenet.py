"""LeNet — BASELINE config 1's model, to ``paddle_tpu/models/lenet.py``
(reference: test/book/test_recognize_digits.py's conv-pool network)."""
from __future__ import annotations

import torch

from .. import nn as pnn
from ._seeding import finish_model, init_generator

__all__ = ["LeNet"]


class LeNet(pnn.Layer):
    """``LeNet(num_classes=10, device=None, dtype=torch.float32, seed=0)``
    on 1 x 28 x 28 inputs; ``seed=None`` leaves the weights uninitialised
    for a load."""

    def __init__(self, num_classes=10, device=None, dtype=torch.float32,
                 seed=0):
        super().__init__()
        dev, gen = init_generator(device, seed)
        kw = dict(device=dev, dtype=dtype, generator=gen)
        self.features = pnn.Sequential(
            pnn.Conv2D(1, 6, 5, padding=2, **kw), pnn.ReLU(),
            pnn.MaxPool2D(2, 2),
            pnn.Conv2D(6, 16, 5, **kw), pnn.ReLU(),
            pnn.MaxPool2D(2, 2))
        self.fc = pnn.Sequential(
            pnn.Linear(16 * 5 * 5, 120, **kw), pnn.ReLU(),
            pnn.Linear(120, 84, **kw), pnn.ReLU(),
            pnn.Linear(84, num_classes, **kw))
        finish_model(self, dev, seed)

    def forward(self, x):
        return self.fc(self.features(x).flatten(1))
