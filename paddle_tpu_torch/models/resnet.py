"""ResNet family (counterpart of paddle_tpu/models/resnet.py; BASELINE.md's
"ResNet-50 / CIFAR-10, 1 chip, dygraph" row).

The submodule names are the reference's (`conv1`, `bn1`,
`layer1.0.conv1`, `layer1.0.downsample.0`, ..., `fc`), so one state_dict
key names one reference parameter or batch-norm buffer (`_mean`,
`_variance`); conv weights share the reference's layout, the `fc` weight
is [out, in] (framework_io transposes the reference's). Convolutions,
batch norm and pooling are plain PyTorch (the reference leaves them to
XLA); no kernel of this path is a hand-written one.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .. import resolve_device
from ..nn.container import Sequential
from ..nn.conv_pool import AdaptiveAvgPool2D, Conv2D, MaxPool2D
from ..nn.layers_common import Identity, Linear, ReLU
from ..nn.norm import BatchNorm2D
from ..ops.manipulation import flatten


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 **factory):
        super().__init__()
        self.conv1 = Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                            bias_attr=False, **factory)
        self.bn1 = BatchNorm2D(planes, **factory)
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            **factory)
        self.bn2 = BatchNorm2D(planes, **factory)
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, **factory):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False, **factory)
        self.bn1 = BatchNorm2D(width, **factory)
        self.conv2 = Conv2D(width, width, 3, stride=stride, padding=1,
                            groups=groups, bias_attr=False, **factory)
        self.bn2 = BatchNorm2D(width, **factory)
        self.conv3 = Conv2D(width, planes * 4, 1, bias_attr=False,
                            **factory)
        self.bn3 = BatchNorm2D(planes * 4, **factory)
        self.relu = ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


_DEPTHS = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
           101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}


class ResNet(nn.Module):
    """`block` (BasicBlock or BottleneckBlock) stacked by `depth_cfg` (a
    list of four counts, or a depth: 18, 34, 50, 101, 152). `small_input`:
    the CIFAR stem (3x3 conv, no max pool) for 32x32 images; `groups` and
    `width` the ResNeXt and wide variants (Bottleneck only); `with_pool`
    the global average pool; `num_classes` 0 drops `fc`. `device`
    defaults to the CUDA card (and raises without one); `generator` seeds
    the reference's initializers (conv weights Uniform(-k, k), k = 1 /
    sqrt(fan_in); the `fc` weight XavierNormal and its bias zero; batch
    norm scales one, shifts zero)."""

    def __init__(self, block, depth_cfg, num_classes=1000, with_pool=True,
                 small_input=False, groups=1, width=64, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if isinstance(depth_cfg, int):
            depth_cfg = _DEPTHS[depth_cfg]
        self._factory = {"device": resolve_device(device)}
        self.groups = groups
        self.base_width = width
        self.inplanes = 64
        if small_input:
            self.conv1 = Conv2D(3, 64, 3, padding=1, bias_attr=False,
                                **self._factory)
            self.maxpool = Identity()
        else:
            self.conv1 = Conv2D(3, 64, 7, stride=2, padding=3,
                                bias_attr=False, **self._factory)
            self.maxpool = MaxPool2D(3, stride=2, padding=1)
        self.bn1 = BatchNorm2D(64, **self._factory)
        self.relu = ReLU()
        self.layer1 = self._make_layer(block, 64, depth_cfg[0])
        self.layer2 = self._make_layer(block, 128, depth_cfg[1], 2)
        self.layer3 = self._make_layer(block, 256, depth_cfg[2], 2)
        self.layer4 = self._make_layer(block, 512, depth_cfg[3], 2)
        self.avgpool = AdaptiveAvgPool2D((1, 1)) if with_pool else None
        self.fc = (Linear(512 * block.expansion, num_classes,
                          **self._factory) if num_classes > 0 else None)
        self._init_weights(generator)

    def _make_layer(self, block, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, **self._factory),
                BatchNorm2D(planes * block.expansion, **self._factory))
        extra = dict(self._factory)
        if issubclass(block, BottleneckBlock):
            extra.update(groups=self.groups, base_width=self.base_width)
        elif self.groups != 1 or self.base_width != 64:
            raise ValueError(
                "BasicBlock only supports groups=1 and width=64; use "
                "BottleneckBlock for resnext/wide variants")
        layers = [block(self.inplanes, planes, stride, downsample, **extra)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, **extra))
        return Sequential(*layers)

    @torch.no_grad()
    def _init_weights(self, generator):
        for mod in self.modules():
            if isinstance(mod, Conv2D):
                mod.reset_parameters(generator)
            elif isinstance(mod, Linear):
                fan_out, fan_in = mod.weight.shape
                mod.weight.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)),
                                   generator=generator)
                mod.bias.zero_()

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.avgpool is not None:
            x = self.avgpool(x)
        if self.fc is not None:
            x = self.fc(flatten(x, 1))
        return x


def resnet18(pretrained=False, num_classes=1000, **kwargs):
    return ResNet(BasicBlock, [2, 2, 2, 2], num_classes, **kwargs)


def resnet34(pretrained=False, num_classes=1000, **kwargs):
    return ResNet(BasicBlock, [3, 4, 6, 3], num_classes, **kwargs)


def resnet50(pretrained=False, num_classes=1000, **kwargs):
    return ResNet(BottleneckBlock, [3, 4, 6, 3], num_classes, **kwargs)


def resnet101(pretrained=False, num_classes=1000, **kwargs):
    return ResNet(BottleneckBlock, [3, 4, 23, 3], num_classes, **kwargs)


def resnet152(pretrained=False, num_classes=1000, **kwargs):
    return ResNet(BottleneckBlock, [3, 8, 36, 3], num_classes, **kwargs)
