"""ResNet — BASELINE config 2's model family, to
``paddle_tpu/models/resnet.py`` (reference: python/paddle/vision/models/
resnet.py): BasicBlock, BottleneckBlock (grouped for ResNeXt, wider for
the wide ResNets) and every factory of ``resnet.py:108-164``.

Blocks take ``device``, ``dtype`` and ``generator`` for their parameters;
:class:`ResNet` and the factories take ``device``, ``dtype`` and ``seed``
(``seed=None`` leaves the weights uninitialised for a load). The residual
add is the ``add`` op, so under ``auto_cast`` O2 it casts the f32 batch
norm output back to the AMP dtype as the JAX package does.
"""
from __future__ import annotations

import torch

from .. import nn as pnn
from ..ops.math import add
from ._seeding import finish_model, init_generator

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "wide_resnet50_2", "wide_resnet101_2", "resnext50_32x4d",
           "resnext50_64x4d", "resnext101_32x4d", "resnext101_64x4d",
           "resnext152_32x4d", "resnext152_64x4d"]


class BasicBlock(pnn.Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.conv1 = pnn.Conv2D(inplanes, planes, 3, stride=stride,
                                padding=1, bias_attr=False, **kw)
        self.bn1 = pnn.BatchNorm2D(planes, **kw)
        self.conv2 = pnn.Conv2D(planes, planes, 3, padding=1,
                                bias_attr=False, **kw)
        self.bn2 = pnn.BatchNorm2D(planes, **kw)
        self.downsample = downsample
        self.relu = pnn.ReLU()

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(add(out, identity))


class BottleneckBlock(pnn.Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = pnn.Conv2D(inplanes, width, 1, bias_attr=False, **kw)
        self.bn1 = pnn.BatchNorm2D(width, **kw)
        self.conv2 = pnn.Conv2D(width, width, 3, stride=stride, padding=1,
                                groups=groups, bias_attr=False, **kw)
        self.bn2 = pnn.BatchNorm2D(width, **kw)
        self.conv3 = pnn.Conv2D(width, planes * 4, 1, bias_attr=False, **kw)
        self.bn3 = pnn.BatchNorm2D(planes * 4, **kw)
        self.downsample = downsample
        self.relu = pnn.ReLU()

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(add(out, identity))


class ResNet(pnn.Layer):
    """``ResNet(block, depth_cfg, num_classes=1000, in_channels=3,
    groups=1, width_per_group=64, device=None, dtype=torch.float32,
    seed=0)``."""

    def __init__(self, block, depth_cfg, num_classes=1000, in_channels=3,
                 groups=1, width_per_group=64, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        dev, gen = init_generator(device, seed)
        self._kw = dict(device=dev, dtype=dtype, generator=gen)
        self.inplanes = 64
        self._groups, self._base_width = groups, width_per_group
        self.conv1 = pnn.Conv2D(in_channels, 64, 7, stride=2, padding=3,
                                bias_attr=False, **self._kw)
        self.bn1 = pnn.BatchNorm2D(64, **self._kw)
        self.relu = pnn.ReLU()
        self.maxpool = pnn.MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, depth_cfg[0])
        self.layer2 = self._make_layer(block, 128, depth_cfg[1], stride=2)
        self.layer3 = self._make_layer(block, 256, depth_cfg[2], stride=2)
        self.layer4 = self._make_layer(block, 512, depth_cfg[3], stride=2)
        self.avgpool = pnn.AdaptiveAvgPool2D(1)
        self.fc = pnn.Linear(512 * block.expansion, num_classes, **self._kw)
        del self._kw
        finish_model(self, dev, seed)

    def _make_layer(self, block, planes, blocks, stride=1):
        kw = self._kw
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = pnn.Sequential(
                pnn.Conv2D(self.inplanes, planes * block.expansion, 1,
                           stride=stride, bias_attr=False, **kw),
                pnn.BatchNorm2D(planes * block.expansion, **kw))
        if block is BottleneckBlock:
            kw = dict(kw, groups=self._groups, base_width=self._base_width)
        layers = [block(self.inplanes, planes, stride, downsample, **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, **kw))
        return pnn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.fc(self.avgpool(x).flatten(1))


def resnet18(num_classes=1000, **kw):
    return ResNet(BasicBlock, [2, 2, 2, 2], num_classes, **kw)


def resnet34(num_classes=1000, **kw):
    return ResNet(BasicBlock, [3, 4, 6, 3], num_classes, **kw)


def resnet50(num_classes=1000, **kw):
    return ResNet(BottleneckBlock, [3, 4, 6, 3], num_classes, **kw)


def resnet101(num_classes=1000, **kw):
    return ResNet(BottleneckBlock, [3, 4, 23, 3], num_classes, **kw)


def resnet152(num_classes=1000, **kw):
    return ResNet(BottleneckBlock, [3, 8, 36, 3], num_classes, **kw)


def wide_resnet50_2(num_classes=1000, **kw):
    return ResNet(BottleneckBlock, [3, 4, 6, 3], num_classes,
                  width_per_group=128, **kw)


def wide_resnet101_2(num_classes=1000, **kw):
    return ResNet(BottleneckBlock, [3, 4, 23, 3], num_classes,
                  width_per_group=128, **kw)


def _resnext(depths, groups, width, num_classes, **kw):
    return ResNet(BottleneckBlock, depths, num_classes, groups=groups,
                  width_per_group=width, **kw)


def resnext50_32x4d(num_classes=1000, **kw):
    return _resnext([3, 4, 6, 3], 32, 4, num_classes, **kw)


def resnext50_64x4d(num_classes=1000, **kw):
    return _resnext([3, 4, 6, 3], 64, 4, num_classes, **kw)


def resnext101_32x4d(num_classes=1000, **kw):
    return _resnext([3, 4, 23, 3], 32, 4, num_classes, **kw)


def resnext101_64x4d(num_classes=1000, **kw):
    return _resnext([3, 4, 23, 3], 64, 4, num_classes, **kw)


def resnext152_32x4d(num_classes=1000, **kw):
    return _resnext([3, 8, 36, 3], 32, 4, num_classes, **kw)


def resnext152_64x4d(num_classes=1000, **kw):
    return _resnext([3, 8, 36, 3], 64, 4, num_classes, **kw)
