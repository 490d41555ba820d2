"""VGG, MobileNetV1/V2 and AlexNet, to ``paddle_tpu/models/vision_zoo.py``
(reference: python/paddle/vision/models/{vgg,mobilenetv1,mobilenetv2,
alexnet}.py), with the JAX package's layer names, so its ``state_dict``
carries over one to one.

Each model takes ``device``, ``dtype`` and ``seed`` (``seed=None`` leaves
the weights uninitialised for a load); the blocks take ``device``,
``dtype`` and ``generator``. The depthwise convolutions are ``Conv2D``
with ``groups == channels`` (cuDNN's grouped convolution on the card, as
XLA's grouped ``conv_general_dilated`` in the JAX package). The inverted
residual's add is the ``add`` op, so under ``auto_cast`` O2 the f32 batch
norm output is cast back to the AMP dtype as in the JAX package.
"""
from __future__ import annotations

import torch

from .. import nn as pnn
from ..ops.math import add
from ._seeding import finish_model, init_generator

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19", "MobileNetV1",
           "MobileNetV2", "AlexNet", "alexnet"]


_VGG_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def _vgg_features(cfg, batch_norm=False, **kw):
    layers = []
    in_c = 3
    for v in _VGG_CFGS[cfg]:
        if v == "M":
            layers.append(pnn.MaxPool2D(kernel_size=2, stride=2))
        else:
            layers.append(pnn.Conv2D(in_c, v, 3, padding=1, **kw))
            if batch_norm:
                layers.append(pnn.BatchNorm2D(v, **kw))
            layers.append(pnn.ReLU())
            in_c = v
    return pnn.Sequential(*layers)


class VGG(pnn.Layer):
    """``VGG(features, num_classes=1000, with_pool=True, batch_norm=False,
    device=None, dtype=torch.float32, seed=0)``: ``features`` is a module,
    or a configuration key of ``_VGG_CFGS`` ("A" 11, "B" 13, "D" 16, "E"
    19 layers) built here with ``batch_norm``."""

    def __init__(self, features, num_classes=1000, with_pool=True,
                 batch_norm=False, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        dev, gen = init_generator(device, seed)
        kw = dict(device=dev, dtype=dtype, generator=gen)
        if isinstance(features, str):
            features = _vgg_features(features, batch_norm, **kw)
        self.features = features
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = pnn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = pnn.Sequential(
                pnn.Linear(512 * 7 * 7, 4096, **kw), pnn.ReLU(),
                pnn.Dropout(), pnn.Linear(4096, 4096, **kw), pnn.ReLU(),
                pnn.Dropout(), pnn.Linear(4096, num_classes, **kw))
        self.num_classes = num_classes
        finish_model(self, dev, seed)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def _vgg(cfg, pretrained, batch_norm, kw):
    if pretrained:
        raise ValueError("no pretrained weights: build with a seed, or load "
                         "weights with params_from_paddle_tpu")
    return VGG(cfg, batch_norm=batch_norm, **kw)


def vgg11(pretrained=False, batch_norm=False, **kw):
    return _vgg("A", pretrained, batch_norm, kw)


def vgg13(pretrained=False, batch_norm=False, **kw):
    return _vgg("B", pretrained, batch_norm, kw)


def vgg16(pretrained=False, batch_norm=False, **kw):
    return _vgg("D", pretrained, batch_norm, kw)


def vgg19(pretrained=False, batch_norm=False, **kw):
    return _vgg("E", pretrained, batch_norm, kw)


class _ConvBNReLU(pnn.Layer):
    def __init__(self, in_c, out_c, k, stride=1, padding=0, groups=1,
                 relu6=False, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.conv = pnn.Conv2D(in_c, out_c, k, stride=stride,
                               padding=padding, groups=groups,
                               bias_attr=False, **kw)
        self.bn = pnn.BatchNorm2D(out_c, **kw)
        self.act = pnn.ReLU6() if relu6 else pnn.ReLU()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class MobileNetV1(pnn.Layer):
    """Reference: vision/models/mobilenetv1.py (depthwise separable)."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, dtype=torch.float32, seed=0):
        super().__init__()
        dev, gen = init_generator(device, seed)
        kw = dict(device=dev, dtype=dtype, generator=gen)
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return max(int(ch * scale), 8)

        cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 + \
            [(512, 1024, 2), (1024, 1024, 1)]
        layers = [_ConvBNReLU(3, c(32), 3, stride=2, padding=1, **kw)]
        for in_ch, out_ch, s in cfg:
            layers.append(_ConvBNReLU(c(in_ch), c(in_ch), 3, stride=s,
                                      padding=1, groups=c(in_ch), **kw))
            layers.append(_ConvBNReLU(c(in_ch), c(out_ch), 1, **kw))
        self.features = pnn.Sequential(*layers)
        if with_pool:
            self.pool = pnn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = pnn.Linear(c(1024), num_classes, **kw)
        finish_model(self, dev, seed)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


class _InvertedResidual(pnn.Layer):
    def __init__(self, in_c, out_c, stride, expand, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        hidden = int(round(in_c * expand))
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if expand != 1:
            layers.append(_ConvBNReLU(in_c, hidden, 1, relu6=True, **kw))
        layers += [
            _ConvBNReLU(hidden, hidden, 3, stride=stride, padding=1,
                        groups=hidden, relu6=True, **kw),
            pnn.Conv2D(hidden, out_c, 1, bias_attr=False, **kw),
            pnn.BatchNorm2D(out_c, **kw),
        ]
        self.conv = pnn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return add(x, out) if self.use_res else out


class MobileNetV2(pnn.Layer):
    """Reference: vision/models/mobilenetv2.py (inverted residuals)."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, dtype=torch.float32, seed=0):
        super().__init__()
        dev, gen = init_generator(device, seed)
        kw = dict(device=dev, dtype=dtype, generator=gen)
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return max(int(ch * scale + 4) // 8 * 8, 8)

        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        in_c = c(32)
        layers = [_ConvBNReLU(3, in_c, 3, stride=2, padding=1, relu6=True,
                              **kw)]
        for t, ch, n, s in cfg:
            out_c = c(ch)
            for i in range(n):
                layers.append(_InvertedResidual(
                    in_c, out_c, s if i == 0 else 1, t, **kw))
                in_c = out_c
        last = c(1280) if scale > 1.0 else 1280
        layers.append(_ConvBNReLU(in_c, last, 1, relu6=True, **kw))
        self.features = pnn.Sequential(*layers)
        if with_pool:
            self.pool = pnn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = pnn.Sequential(
                pnn.Dropout(0.2), pnn.Linear(last, num_classes, **kw))
        finish_model(self, dev, seed)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


class AlexNet(pnn.Layer):
    """Reference: vision/models/alexnet.py."""

    def __init__(self, num_classes=1000, device=None, dtype=torch.float32,
                 seed=0):
        super().__init__()
        dev, gen = init_generator(device, seed)
        kw = dict(device=dev, dtype=dtype, generator=gen)
        self.features = pnn.Sequential(
            pnn.Conv2D(3, 64, 11, stride=4, padding=2, **kw), pnn.ReLU(),
            pnn.MaxPool2D(3, stride=2),
            pnn.Conv2D(64, 192, 5, padding=2, **kw), pnn.ReLU(),
            pnn.MaxPool2D(3, stride=2),
            pnn.Conv2D(192, 384, 3, padding=1, **kw), pnn.ReLU(),
            pnn.Conv2D(384, 256, 3, padding=1, **kw), pnn.ReLU(),
            pnn.Conv2D(256, 256, 3, padding=1, **kw), pnn.ReLU(),
            pnn.MaxPool2D(3, stride=2))
        self.classifier = pnn.Sequential(
            pnn.Dropout(), pnn.Linear(256 * 6 * 6, 4096, **kw), pnn.ReLU(),
            pnn.Dropout(), pnn.Linear(4096, 4096, **kw), pnn.ReLU(),
            pnn.Linear(4096, num_classes, **kw))
        finish_model(self, dev, seed)

    def forward(self, x):
        return self.classifier(self.features(x).flatten(1))


def alexnet(pretrained=False, **kw):
    if pretrained:
        raise ValueError("no pretrained weights: build with a seed, or load "
                         "weights with params_from_paddle_tpu")
    return AlexNet(**kw)
