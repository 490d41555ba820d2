"""DenseNet, GoogLeNet, InceptionV3, MobileNetV3, ShuffleNetV2 and
SqueezeNet, to ``paddle_tpu/models/vision_zoo2.py`` (reference:
python/paddle/vision/models/{densenet,googlenet,inceptionv3,mobilenetv3,
shufflenetv2,squeezenet}.py): the JAX file's architectures and layer
names, not torchvision's — GoogLeNet returns ``(out, aux1, aux2)`` in
training, InceptionV3 is the JAX package's compact variant (stem, 3 A,
reduction A, 4 B, reduction B, 2 C, head), and the squeeze-excite gate is
``hardsigmoid`` at its default slope ``0.1666667``.

Each model takes ``device``, ``dtype`` and ``seed`` (``seed=None`` leaves
the weights uninitialised for a load); the blocks take ``device``,
``dtype`` and ``generator``. Branches join through the ``concat`` op, the
residual adds through ``add`` and the gate through ``multiply``, so under
``auto_cast`` each casts as the JAX op of that name does.
"""
from __future__ import annotations

import torch

from .. import nn as pnn
from ..nn import functional as F
from ..ops.manipulation import concat
from ..ops.math import add, multiply
from ._seeding import finish_model, init_generator

__all__ = [
    "DenseNet", "densenet121", "densenet161", "densenet169", "densenet201",
    "densenet264", "GoogLeNet", "googlenet", "InceptionV3", "inception_v3",
    "MobileNetV3Large", "MobileNetV3Small", "mobilenet_v3_large",
    "mobilenet_v3_small", "mobilenet_v1", "mobilenet_v2", "ShuffleNetV2",
    "shufflenet_v2_x0_25", "shufflenet_v2_x0_33", "shufflenet_v2_x0_5",
    "shufflenet_v2_x1_0", "shufflenet_v2_x1_5", "shufflenet_v2_x2_0",
    "shufflenet_v2_swish", "SqueezeNet", "squeezenet1_0", "squeezenet1_1",
]

_ACTS = {"relu": pnn.ReLU, "hardswish": pnn.Hardswish, "swish": pnn.Silu}


def _conv_bn(cin, cout, k, stride=1, padding=0, groups=1, act="relu",
             **kw):
    """Conv (no bias) -> BatchNorm2D -> ``act`` ("relu", "hardswish",
    "swish" or "none"), as a ``Sequential`` named 0, 1, 2."""
    layers = [pnn.Conv2D(cin, cout, k, stride=stride, padding=padding,
                         groups=groups, bias_attr=False, **kw),
              pnn.BatchNorm2D(cout, **kw)]
    if act in _ACTS:
        layers.append(_ACTS[act]())
    return pnn.Sequential(*layers)


# ---------------------------------------------------------------- DenseNet
class _DenseLayer(pnn.Layer):
    def __init__(self, cin, growth, bn_size, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.norm1 = pnn.BatchNorm2D(cin, **kw)
        self.conv1 = pnn.Conv2D(cin, bn_size * growth, 1, bias_attr=False,
                                **kw)
        self.norm2 = pnn.BatchNorm2D(bn_size * growth, **kw)
        self.conv2 = pnn.Conv2D(bn_size * growth, growth, 3, padding=1,
                                bias_attr=False, **kw)

    def forward(self, x):
        out = self.conv1(F.relu(self.norm1(x)))
        out = self.conv2(F.relu(self.norm2(out)))
        return concat([x, out], axis=1)


class DenseNet(pnn.Layer):
    """Reference: vision/models/densenet.py DenseNet. Every layer of a
    block concatenates its ``growth`` channels onto its input, so a
    block's activations grow with the square of its depth."""

    _CFG = {121: (32, [6, 12, 24, 16], 64), 161: (48, [6, 12, 36, 24], 96),
            169: (32, [6, 12, 32, 32], 64), 201: (32, [6, 12, 48, 32], 64),
            264: (32, [6, 12, 64, 48], 64)}

    def __init__(self, layers=121, bn_size=4, dropout=0.0, num_classes=1000,
                 with_pool=True, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        dev, gen = init_generator(device, seed)
        kw = dict(device=dev, dtype=dtype, generator=gen)
        growth, blocks, init_c = self._CFG[layers]
        self.stem = pnn.Sequential(
            pnn.Conv2D(3, init_c, 7, stride=2, padding=3, bias_attr=False,
                       **kw),
            pnn.BatchNorm2D(init_c, **kw), pnn.ReLU(),
            pnn.MaxPool2D(3, stride=2, padding=1))
        c = init_c
        feats = []
        for i, n in enumerate(blocks):
            for _ in range(n):
                feats.append(_DenseLayer(c, growth, bn_size, **kw))
                c += growth
            if i != len(blocks) - 1:
                feats.append(pnn.Sequential(
                    pnn.BatchNorm2D(c, **kw), pnn.ReLU(),
                    pnn.Conv2D(c, c // 2, 1, bias_attr=False, **kw),
                    pnn.AvgPool2D(2, stride=2)))
                c //= 2
        self.features = pnn.Sequential(*feats)
        self.norm_final = pnn.BatchNorm2D(c, **kw)
        self.pool = pnn.AdaptiveAvgPool2D(1) if with_pool else None
        self.classifier = pnn.Linear(c, num_classes, **kw) \
            if num_classes > 0 else None
        finish_model(self, dev, seed)

    def forward(self, x):
        x = F.relu(self.norm_final(self.features(self.stem(x))))
        if self.pool is not None:
            x = self.pool(x)
        if self.classifier is not None:
            x = self.classifier(x.flatten(1))
        return x


def densenet121(**kw):
    return DenseNet(121, **kw)


def densenet161(**kw):
    return DenseNet(161, **kw)


def densenet169(**kw):
    return DenseNet(169, **kw)


def densenet201(**kw):
    return DenseNet(201, **kw)


def densenet264(**kw):
    return DenseNet(264, **kw)


# --------------------------------------------------------------- GoogLeNet
class _Inception(pnn.Layer):
    def __init__(self, cin, c1, c3r, c3, c5r, c5, proj, device=None,
                 dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.b1 = _conv_bn(cin, c1, 1, **kw)
        self.b2 = pnn.Sequential(_conv_bn(cin, c3r, 1, **kw),
                                 _conv_bn(c3r, c3, 3, padding=1, **kw))
        self.b3 = pnn.Sequential(_conv_bn(cin, c5r, 1, **kw),
                                 _conv_bn(c5r, c5, 5, padding=2, **kw))
        self.b4 = pnn.Sequential(pnn.MaxPool2D(3, stride=1, padding=1),
                                 _conv_bn(cin, proj, 1, **kw))

    def forward(self, x):
        return concat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)],
                      axis=1)


class GoogLeNet(pnn.Layer):
    """Reference: vision/models/googlenet.py (inception v1); in training
    returns ``(out, aux1, aux2)``, in eval ``out``."""

    def __init__(self, num_classes=1000, with_pool=True, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        dev, gen = init_generator(device, seed)
        kw = dict(device=dev, dtype=dtype, generator=gen)
        self.stem = pnn.Sequential(
            _conv_bn(3, 64, 7, stride=2, padding=3, **kw),
            pnn.MaxPool2D(3, stride=2, padding=1),
            _conv_bn(64, 64, 1, **kw), _conv_bn(64, 192, 3, padding=1, **kw),
            pnn.MaxPool2D(3, stride=2, padding=1))
        self.i3a = _Inception(192, 64, 96, 128, 16, 32, 32, **kw)
        self.i3b = _Inception(256, 128, 128, 192, 32, 96, 64, **kw)
        self.pool3 = pnn.MaxPool2D(3, stride=2, padding=1)
        self.i4a = _Inception(480, 192, 96, 208, 16, 48, 64, **kw)
        self.i4b = _Inception(512, 160, 112, 224, 24, 64, 64, **kw)
        self.i4c = _Inception(512, 128, 128, 256, 24, 64, 64, **kw)
        self.i4d = _Inception(512, 112, 144, 288, 32, 64, 64, **kw)
        self.i4e = _Inception(528, 256, 160, 320, 32, 128, 128, **kw)
        self.pool4 = pnn.MaxPool2D(3, stride=2, padding=1)
        self.i5a = _Inception(832, 256, 160, 320, 32, 128, 128, **kw)
        self.i5b = _Inception(832, 384, 192, 384, 48, 128, 128, **kw)
        self.pool = pnn.AdaptiveAvgPool2D(1)
        self.dropout = pnn.Dropout(0.4)
        self.fc = pnn.Linear(1024, num_classes, **kw)
        self.aux1 = pnn.Sequential(pnn.AdaptiveAvgPool2D(4),
                                   _conv_bn(512, 128, 1, **kw), pnn.Flatten(),
                                   pnn.Linear(128 * 16, num_classes, **kw))
        self.aux2 = pnn.Sequential(pnn.AdaptiveAvgPool2D(4),
                                   _conv_bn(528, 128, 1, **kw), pnn.Flatten(),
                                   pnn.Linear(128 * 16, num_classes, **kw))
        finish_model(self, dev, seed)

    def forward(self, x):
        x = self.i4a(self.pool3(self.i3b(self.i3a(self.stem(x)))))
        a1 = self.aux1(x) if self.training else None
        x = self.i4d(self.i4c(self.i4b(x)))
        a2 = self.aux2(x) if self.training else None
        x = self.i5b(self.i5a(self.pool4(self.i4e(x))))
        out = self.fc(self.dropout(self.pool(x)).flatten(1))
        if self.training:
            return out, a1, a2
        return out


def googlenet(**kw):
    return GoogLeNet(**kw)


# ------------------------------------------------------------- InceptionV3
class _InceptionA(pnn.Layer):
    def __init__(self, cin, pool_feat, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.b1 = _conv_bn(cin, 64, 1, **kw)
        self.b5 = pnn.Sequential(_conv_bn(cin, 48, 1, **kw),
                                 _conv_bn(48, 64, 5, padding=2, **kw))
        self.b3 = pnn.Sequential(_conv_bn(cin, 64, 1, **kw),
                                 _conv_bn(64, 96, 3, padding=1, **kw),
                                 _conv_bn(96, 96, 3, padding=1, **kw))
        self.bp = pnn.Sequential(pnn.AvgPool2D(3, stride=1, padding=1),
                                 _conv_bn(cin, pool_feat, 1, **kw))

    def forward(self, x):
        return concat([self.b1(x), self.b5(x), self.b3(x), self.bp(x)],
                      axis=1)


class _ReductionA(pnn.Layer):
    def __init__(self, cin, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.b3 = _conv_bn(cin, 384, 3, stride=2, **kw)
        self.b33 = pnn.Sequential(_conv_bn(cin, 64, 1, **kw),
                                  _conv_bn(64, 96, 3, padding=1, **kw),
                                  _conv_bn(96, 96, 3, stride=2, **kw))
        self.pool = pnn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return concat([self.b3(x), self.b33(x), self.pool(x)], axis=1)


class _InceptionB(pnn.Layer):
    def __init__(self, cin, c7, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.b1 = _conv_bn(cin, 192, 1, **kw)
        self.b7 = pnn.Sequential(
            _conv_bn(cin, c7, 1, **kw),
            _conv_bn(c7, c7, (1, 7), padding=(0, 3), **kw),
            _conv_bn(c7, 192, (7, 1), padding=(3, 0), **kw))
        self.b77 = pnn.Sequential(
            _conv_bn(cin, c7, 1, **kw),
            _conv_bn(c7, c7, (7, 1), padding=(3, 0), **kw),
            _conv_bn(c7, c7, (1, 7), padding=(0, 3), **kw),
            _conv_bn(c7, c7, (7, 1), padding=(3, 0), **kw),
            _conv_bn(c7, 192, (1, 7), padding=(0, 3), **kw))
        self.bp = pnn.Sequential(pnn.AvgPool2D(3, stride=1, padding=1),
                                 _conv_bn(cin, 192, 1, **kw))

    def forward(self, x):
        return concat([self.b1(x), self.b7(x), self.b77(x), self.bp(x)],
                      axis=1)


class _ReductionB(pnn.Layer):
    """InceptionD in the reference naming: 768 -> 1280."""

    def __init__(self, cin, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.b3 = pnn.Sequential(_conv_bn(cin, 192, 1, **kw),
                                 _conv_bn(192, 320, 3, stride=2, **kw))
        self.b7 = pnn.Sequential(
            _conv_bn(cin, 192, 1, **kw),
            _conv_bn(192, 192, (1, 7), padding=(0, 3), **kw),
            _conv_bn(192, 192, (7, 1), padding=(3, 0), **kw),
            _conv_bn(192, 192, 3, stride=2, **kw))
        self.pool = pnn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return concat([self.b3(x), self.b7(x), self.pool(x)], axis=1)


class _InceptionC(pnn.Layer):
    """InceptionE in the reference naming: split 3x3 branches concat to
    2048 channels."""

    def __init__(self, cin, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.b1 = _conv_bn(cin, 320, 1, **kw)
        self.b3_stem = _conv_bn(cin, 384, 1, **kw)
        self.b3_a = _conv_bn(384, 384, (1, 3), padding=(0, 1), **kw)
        self.b3_b = _conv_bn(384, 384, (3, 1), padding=(1, 0), **kw)
        self.b33_stem = pnn.Sequential(_conv_bn(cin, 448, 1, **kw),
                                       _conv_bn(448, 384, 3, padding=1,
                                                **kw))
        self.b33_a = _conv_bn(384, 384, (1, 3), padding=(0, 1), **kw)
        self.b33_b = _conv_bn(384, 384, (3, 1), padding=(1, 0), **kw)
        self.bp = pnn.Sequential(pnn.AvgPool2D(3, stride=1, padding=1),
                                 _conv_bn(cin, 192, 1, **kw))

    def forward(self, x):
        h3 = self.b3_stem(x)
        h33 = self.b33_stem(x)
        return concat([self.b1(x), self.b3_a(h3), self.b3_b(h3),
                       self.b33_a(h33), self.b33_b(h33), self.bp(x)], axis=1)


class InceptionV3(pnn.Layer):
    """Reference: vision/models/inceptionv3.py — stem -> 3 A ->
    reduction A -> 4 B -> reduction B -> 2 C -> head (channels
    192-256-288-288-768-768 x 4-1280-2048-2048), on 3 x 299 x 299."""

    def __init__(self, num_classes=1000, with_pool=True, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        dev, gen = init_generator(device, seed)
        kw = dict(device=dev, dtype=dtype, generator=gen)
        self.stem = pnn.Sequential(
            _conv_bn(3, 32, 3, stride=2, **kw), _conv_bn(32, 32, 3, **kw),
            _conv_bn(32, 64, 3, padding=1, **kw), pnn.MaxPool2D(3, stride=2),
            _conv_bn(64, 80, 1, **kw), _conv_bn(80, 192, 3, **kw),
            pnn.MaxPool2D(3, stride=2))
        self.a1 = _InceptionA(192, 32, **kw)
        self.a2 = _InceptionA(256, 64, **kw)
        self.a3 = _InceptionA(288, 64, **kw)
        self.red_a = _ReductionA(288, **kw)
        self.b1 = _InceptionB(768, 128, **kw)
        self.b2 = _InceptionB(768, 160, **kw)
        self.b3 = _InceptionB(768, 160, **kw)
        self.b4 = _InceptionB(768, 192, **kw)
        self.red_b = _ReductionB(768, **kw)
        self.c1 = _InceptionC(1280, **kw)
        self.c2 = _InceptionC(2048, **kw)
        self.pool = pnn.AdaptiveAvgPool2D(1)
        self.dropout = pnn.Dropout(0.5)
        self.fc = pnn.Linear(2048, num_classes, **kw)
        finish_model(self, dev, seed)

    def forward(self, x):
        x = self.stem(x)
        x = self.red_a(self.a3(self.a2(self.a1(x))))
        x = self.red_b(self.b4(self.b3(self.b2(self.b1(x)))))
        x = self.c2(self.c1(x))
        return self.fc(self.dropout(self.pool(x)).flatten(1))


def inception_v3(**kw):
    return InceptionV3(**kw)


# ------------------------------------------------------------- MobileNetV3
class _SE(pnn.Layer):
    """Squeeze-excite: ``x * hardsigmoid(fc2(relu(fc1(pool(x)))))``."""

    def __init__(self, c, r=4, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.pool = pnn.AdaptiveAvgPool2D(1)
        self.fc1 = pnn.Conv2D(c, c // r, 1, **kw)
        self.fc2 = pnn.Conv2D(c // r, c, 1, **kw)

    def forward(self, x):
        s = F.relu(self.fc1(self.pool(x)))
        return multiply(x, F.hardsigmoid(self.fc2(s)))


class _MBV3Block(pnn.Layer):
    def __init__(self, cin, exp, cout, k, stride, se, act, device=None,
                 dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.use_res = stride == 1 and cin == cout
        layers = []
        if exp != cin:
            layers.append(_conv_bn(cin, exp, 1, act=act, **kw))
        layers.append(_conv_bn(exp, exp, k, stride=stride, padding=k // 2,
                               groups=exp, act=act, **kw))
        if se:
            layers.append(_SE(exp, **kw))
        layers.append(_conv_bn(exp, cout, 1, act="none", **kw))
        self.block = pnn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return add(x, out) if self.use_res else out


_V3_LARGE = [  # k, exp, out, se, act, stride (reference config)
    (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2), (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1), (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1), (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2), (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1)]

_V3_SMALL = [
    (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1), (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1), (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2), (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1)]


class _MobileNetV3(pnn.Layer):
    def __init__(self, cfg, last_c, num_classes=1000, scale=1.0, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        dev, gen = init_generator(device, seed)
        kw = dict(device=dev, dtype=dtype, generator=gen)

        def _c(v):
            return max(8, int(v * scale + 4) // 8 * 8)

        cin = _c(16)
        layers = [_conv_bn(3, cin, 3, stride=2, padding=1, act="hardswish",
                           **kw)]
        for k, exp, cout, se, act, stride in cfg:
            layers.append(_MBV3Block(cin, _c(exp), _c(cout), k, stride, se,
                                     act, **kw))
            cin = _c(cout)
        self.features = pnn.Sequential(*layers)
        self.final_conv = _conv_bn(cin, _c(cfg[-1][1]), 1, act="hardswish",
                                   **kw)
        self.pool = pnn.AdaptiveAvgPool2D(1)
        self.head = pnn.Sequential(
            pnn.Linear(_c(cfg[-1][1]), last_c, **kw), pnn.Hardswish(),
            pnn.Dropout(0.2), pnn.Linear(last_c, num_classes, **kw))
        finish_model(self, dev, seed)

    def forward(self, x):
        x = self.pool(self.final_conv(self.features(x))).flatten(1)
        return self.head(x)


class MobileNetV3Large(_MobileNetV3):
    """Reference: vision/models/mobilenetv3.py MobileNetV3Large."""

    def __init__(self, scale=1.0, num_classes=1000, device=None,
                 dtype=torch.float32, seed=0, **kw):
        super().__init__(_V3_LARGE, 1280, num_classes, scale, device, dtype,
                         seed)


class MobileNetV3Small(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, device=None,
                 dtype=torch.float32, seed=0, **kw):
        super().__init__(_V3_SMALL, 1024, num_classes, scale, device, dtype,
                         seed)


def mobilenet_v3_large(**kw):
    return MobileNetV3Large(**kw)


def mobilenet_v3_small(**kw):
    return MobileNetV3Small(**kw)


def mobilenet_v1(**kw):
    from .vision_zoo import MobileNetV1
    return MobileNetV1(**kw)


def mobilenet_v2(**kw):
    from .vision_zoo import MobileNetV2
    return MobileNetV2(**kw)


# ------------------------------------------------------------ ShuffleNetV2
class _ShuffleUnit(pnn.Layer):
    def __init__(self, cin, cout, stride, act, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.stride = stride
        branch_c = cout // 2
        if stride == 1:
            self.branch2 = pnn.Sequential(
                _conv_bn(branch_c, branch_c, 1, act=act, **kw),
                _conv_bn(branch_c, branch_c, 3, stride=1, padding=1,
                         groups=branch_c, act="none", **kw),
                _conv_bn(branch_c, branch_c, 1, act=act, **kw))
            self.branch1 = None
        else:
            self.branch1 = pnn.Sequential(
                _conv_bn(cin, cin, 3, stride=stride, padding=1, groups=cin,
                         act="none", **kw),
                _conv_bn(cin, branch_c, 1, act=act, **kw))
            self.branch2 = pnn.Sequential(
                _conv_bn(cin, branch_c, 1, act=act, **kw),
                _conv_bn(branch_c, branch_c, 3, stride=stride, padding=1,
                         groups=branch_c, act="none", **kw),
                _conv_bn(branch_c, branch_c, 1, act=act, **kw))

    def forward(self, x):
        if self.stride == 1:
            c = x.shape[1] // 2
            out = concat([x[:, :c], self.branch2(x[:, c:])], axis=1)
        else:
            out = concat([self.branch1(x), self.branch2(x)], axis=1)
        return F.channel_shuffle(out, 2)


_SHUFFLE_CFG = {
    0.25: [24, 24, 48, 96, 512], 0.33: [24, 32, 64, 128, 512],
    0.5: [24, 48, 96, 192, 1024], 1.0: [24, 116, 232, 464, 1024],
    1.5: [24, 176, 352, 704, 1024], 2.0: [24, 244, 488, 976, 2048]}


class ShuffleNetV2(pnn.Layer):
    """Reference: vision/models/shufflenetv2.py."""

    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        dev, gen = init_generator(device, seed)
        kw = dict(device=dev, dtype=dtype, generator=gen)
        c = _SHUFFLE_CFG[scale]
        self.stem = pnn.Sequential(
            _conv_bn(3, c[0], 3, stride=2, padding=1, act=act, **kw),
            pnn.MaxPool2D(3, stride=2, padding=1))
        stages = []
        cin = c[0]
        for stage_i, repeat in enumerate([4, 8, 4]):
            cout = c[stage_i + 1]
            stages.append(_ShuffleUnit(cin, cout, 2, act, **kw))
            for _ in range(repeat - 1):
                stages.append(_ShuffleUnit(cout, cout, 1, act, **kw))
            cin = cout
        self.stages = pnn.Sequential(*stages)
        self.final_conv = _conv_bn(cin, c[4], 1, act=act, **kw)
        self.pool = pnn.AdaptiveAvgPool2D(1)
        self.fc = pnn.Linear(c[4], num_classes, **kw)
        finish_model(self, dev, seed)

    def forward(self, x):
        x = self.final_conv(self.stages(self.stem(x)))
        return self.fc(self.pool(x).flatten(1))


def shufflenet_v2_x0_25(**kw):
    return ShuffleNetV2(scale=0.25, **kw)


def shufflenet_v2_x0_33(**kw):
    return ShuffleNetV2(scale=0.33, **kw)


def shufflenet_v2_x0_5(**kw):
    return ShuffleNetV2(scale=0.5, **kw)


def shufflenet_v2_x1_0(**kw):
    return ShuffleNetV2(scale=1.0, **kw)


def shufflenet_v2_x1_5(**kw):
    return ShuffleNetV2(scale=1.5, **kw)


def shufflenet_v2_x2_0(**kw):
    return ShuffleNetV2(scale=2.0, **kw)


def shufflenet_v2_swish(**kw):
    return ShuffleNetV2(scale=1.0, act="swish", **kw)


# -------------------------------------------------------------- SqueezeNet
class _Fire(pnn.Layer):
    def __init__(self, cin, squeeze, e1, e3, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.squeeze = pnn.Conv2D(cin, squeeze, 1, **kw)
        self.e1 = pnn.Conv2D(squeeze, e1, 1, **kw)
        self.e3 = pnn.Conv2D(squeeze, e3, 3, padding=1, **kw)

    def forward(self, x):
        s = F.relu(self.squeeze(x))
        return concat([F.relu(self.e1(s)), F.relu(self.e3(s))], axis=1)


class SqueezeNet(pnn.Layer):
    """Reference: vision/models/squeezenet.py (1.0 and 1.1 variants)."""

    def __init__(self, version="1.0", num_classes=1000, with_pool=True,
                 device=None, dtype=torch.float32, seed=0):
        super().__init__()
        dev, gen = init_generator(device, seed)
        kw = dict(device=dev, dtype=dtype, generator=gen)
        if str(version) == "1.0":
            self.features = pnn.Sequential(
                pnn.Conv2D(3, 96, 7, stride=2, **kw), pnn.ReLU(),
                pnn.MaxPool2D(3, stride=2),
                _Fire(96, 16, 64, 64, **kw), _Fire(128, 16, 64, 64, **kw),
                _Fire(128, 32, 128, 128, **kw), pnn.MaxPool2D(3, stride=2),
                _Fire(256, 32, 128, 128, **kw),
                _Fire(256, 48, 192, 192, **kw),
                _Fire(384, 48, 192, 192, **kw),
                _Fire(384, 64, 256, 256, **kw),
                pnn.MaxPool2D(3, stride=2), _Fire(512, 64, 256, 256, **kw))
        else:
            self.features = pnn.Sequential(
                pnn.Conv2D(3, 64, 3, stride=2, **kw), pnn.ReLU(),
                pnn.MaxPool2D(3, stride=2),
                _Fire(64, 16, 64, 64, **kw), _Fire(128, 16, 64, 64, **kw),
                pnn.MaxPool2D(3, stride=2),
                _Fire(128, 32, 128, 128, **kw),
                _Fire(256, 32, 128, 128, **kw),
                pnn.MaxPool2D(3, stride=2),
                _Fire(256, 48, 192, 192, **kw),
                _Fire(384, 48, 192, 192, **kw),
                _Fire(384, 64, 256, 256, **kw),
                _Fire(512, 64, 256, 256, **kw))
        self.classifier = pnn.Sequential(
            pnn.Dropout(0.5), pnn.Conv2D(512, num_classes, 1, **kw),
            pnn.ReLU(), pnn.AdaptiveAvgPool2D(1))
        finish_model(self, dev, seed)

    def forward(self, x):
        return self.classifier(self.features(x)).flatten(1)


def squeezenet1_0(**kw):
    return SqueezeNet("1.0", **kw)


def squeezenet1_1(**kw):
    return SqueezeNet("1.1", **kw)
