"""ResNet / ResNeXt / WideResNet encoders (``nn.Module``s, NCHW inside).

Counterpart of ``celldetection_tpu/models/resnet.py``: ``BasicBlock`` (33-56),
``Bottleneck`` (59-98), ``_ResLayer`` (101-124), ``ResNetEncoder`` (127-198),
the ten constructors (210-219), the torchvision spellings (222-226) and
``get_resnet`` (240-254); ``pyramid_pooling`` appends a :class:`.ppm.Ppm`
(``body.ppm``) to the deepest level, and ``secondary_block`` (a module
class such as :class:`.mamba.MambaLayer`, built as
``secondary_block(channels)``) follows each stage's layer as
``body.secondary1..4``.

The JAX package's ``GroupedConv`` (a block-diagonal dense conv, a TPU
lowering choice) is a plain ``nn.Conv2d(groups=...)`` here, with the same
weights. Module names are the reference torch layout that
``export_torch_state_dict(encoder='resnet')`` writes: blocks carry
``conv1/bn1/.../conv3/bn3`` and ``downsample.{0,1}``; with
``fused_initial=False`` ``body.0`` is the stem (conv, bn, relu), ``body.1``
is ``Sequential(MaxPool2d(3, 2, 1), layer1)`` and ``body.2..4`` are
layer2..4; with ``fused_initial=True`` ``body.0`` is ``Sequential(conv, bn,
relu, pool, layer1)`` and ``body.1..3`` are layer2..4. ``nd=3`` builds the
same encoder for NCDHW volumes (``Conv3d``, the stem's 7^3 convolution, a
3-D max-pool), as the JAX package runs it on 5-D input.
"""
from typing import Dict, Sequence

import torch
from torch import nn

from .commons import Norm, conv_nd, max_pool_nd
from .ppm import Ppm

__all__ = ['BasicBlock', 'Bottleneck', 'ResNetEncoder', 'ResNet18', 'ResNet34', 'ResNet50',
           'ResNet101', 'ResNet152', 'ResNeXt50', 'ResNeXt101', 'ResNeXt152', 'WideResNet50',
           'WideResNet101', 'get_resnet', 'ResNeXt50_32x4d', 'ResNeXt101_32x8d',
           'ResNeXt152_32x8d', 'WideResNet50_2', 'WideResNet101_2']


def _downsample(in_channels, out_channels, stride, norm_layer, nd):
    return nn.Sequential(conv_nd(nd)(in_channels, out_channels, 1, stride=stride, bias=False),
                         Norm(out_channels, norm_layer))


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity (torchvision ``BasicBlock``)."""
    expansion = 1

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 norm_layer: str = 'batchnorm2d', kernel_size: int = 3, nd: int = 2):
        super().__init__()
        conv = conv_nd(nd)
        self.conv1 = conv(in_channels, planes, kernel_size, stride=stride,
                          padding=(kernel_size - 1) // 2, bias=False)
        self.bn1 = Norm(planes, norm_layer)
        self.conv2 = conv(planes, planes, 3, padding=1, bias=False)
        self.bn2 = Norm(planes, norm_layer)
        self.relu = nn.ReLU()
        self.downsample = _downsample(in_channels, planes, stride, norm_layer, nd) \
            if stride != 1 or in_channels != planes else None

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        return self.relu(self.bn2(self.conv2(out)) + identity)


class Bottleneck(nn.Module):
    """1x1 → 3x3 (``groups``) → 1x1 bottleneck (torchvision ``Bottleneck``, expansion 4)."""
    expansion = 4

    def __init__(self, in_channels: int, planes: int, stride: int = 1, groups: int = 1,
                 base_width: int = 64, norm_layer: str = 'batchnorm2d', kernel_size: int = 3,
                 nd: int = 2):
        super().__init__()
        width = int(planes * (base_width / 64.)) * groups
        out_c = planes * self.expansion
        conv = conv_nd(nd)
        self.conv1 = conv(in_channels, width, 1, bias=False)
        self.bn1 = Norm(width, norm_layer)
        self.conv2 = conv(width, width, kernel_size, stride=stride,
                          padding=(kernel_size - 1) // 2, groups=groups, bias=False)
        self.bn2 = Norm(width, norm_layer)
        self.conv3 = conv(width, out_c, 1, bias=False)
        self.bn3 = Norm(out_c, norm_layer)
        self.relu = nn.ReLU()
        self.downsample = _downsample(in_channels, out_c, stride, norm_layer, nd) \
            if stride != 1 or in_channels != out_c else None

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        return self.relu(self.bn3(self.conv3(out)) + identity)


def _res_layer(block, in_channels, planes, blocks, stride, groups, base_width, norm_layer, nd):
    """``blocks`` residual blocks; the first may stride and downsample."""
    kw = dict(groups=groups, base_width=base_width) if block is Bottleneck else {}
    layers = []
    for i in range(blocks):
        layers.append(block(in_channels, planes, stride if i == 0 else 1,
                            norm_layer=norm_layer, nd=nd, **kw))
        in_channels = planes * block.expansion
    return nn.Sequential(*layers)


class ResNetEncoder(nn.Sequential):
    """ResNet feature encoder returning a dict of NCHW feature maps (key '0' finest).

    Args:
        layers: Blocks per stage, e.g. ``(3, 4, 6, 3)``.
        bottleneck: ``Bottleneck`` (True) or ``BasicBlock`` (False).
        fused_initial: Stem and layer1 form feature level '0' at stride 4
            (4 levels); otherwise the stem is its own stride-2 level (5 levels).
    """

    def __init__(self, in_channels: int = 3, layers: Sequence[int] = (2, 2, 2, 2),
                 bottleneck: bool = False, base_channel: int = 64, groups: int = 1,
                 base_width: int = 64, fused_initial: bool = True, initial_strides: int = 2,
                 initial_pooling: bool = True, norm_layer: str = 'batchnorm2d',
                 secondary_block=None, pyramid_pooling: bool = False,
                 pyramid_pooling_channels: int = 64, nd: int = 2):
        block = Bottleneck if bottleneck else BasicBlock
        stem = [conv_nd(nd)(in_channels, base_channel, 7, stride=initial_strides, padding=3,
                            bias=False),
                Norm(base_channel, norm_layer), nn.ReLU()]
        pool = max_pool_nd(nd)(3, 2, 1) if initial_pooling else nn.Identity()
        stages, prev = [], base_channel
        for i, blocks in enumerate(layers):
            planes = base_channel * 2 ** i
            stages.append(_res_layer(block, prev, planes, blocks, 1 if i == 0 else 2, groups,
                                     base_width, norm_layer, nd))
            prev = planes * block.expansion
        if fused_initial:
            super().__init__(nn.Sequential(*stem, pool, stages[0]), *stages[1:])
        else:
            super().__init__(nn.Sequential(*stem), nn.Sequential(pool, stages[0]), *stages[1:])
        self.fused_initial = fused_initial
        self.num_stages = len(self)
        e = block.expansion
        self.out_channels = ([] if fused_initial else [base_channel]) + \
            [base_channel * 2 ** i * e for i in range(4)]
        self.out_strides = ([] if fused_initial else [2]) + [4, 8, 16, 32]
        # one secondary block after each stage's layer (``secondary1..4``), as
        # the JAX package applies it, not inside the layer as the reference does
        self.secondary = None if secondary_block is None else [
            f'secondary{i + 1}' for i in range(len(layers))]
        for i, name in enumerate(self.secondary or ()):
            setattr(self, name, secondary_block(base_channel * 2 ** i * e))
        self.ppm = None
        if pyramid_pooling:
            self.ppm = Ppm(self.out_channels[-1], pyramid_pooling_channels, nd=nd)
            self.out_channels[-1] = self.ppm.out_channels

    def forward(self, x) -> Dict[str, torch.Tensor]:
        features = {}
        for i in range(self.num_stages):
            x = self[i](x)
            layer = i if self.fused_initial else i - 1       # the stage's ResNet layer - 1
            if self.secondary is not None and layer >= 0:
                x = getattr(self, self.secondary[layer])(x)
            features[str(i)] = x
        if self.ppm is not None:
            features[str(self.num_stages - 1)] = self.ppm(x)
        return features


def _resnet(layers, bottleneck, groups=1, base_width=64):
    def ctor(in_channels, out_channels=0, fused_initial=True, **kwargs):
        kwargs.pop('pretrained', None)
        return ResNetEncoder(in_channels=in_channels, layers=layers, bottleneck=bottleneck,
                             groups=groups, base_width=base_width, fused_initial=fused_initial,
                             **kwargs)
    return ctor


ResNet18 = _resnet((2, 2, 2, 2), False)
ResNet34 = _resnet((3, 4, 6, 3), False)
ResNet50 = _resnet((3, 4, 6, 3), True)
ResNet101 = _resnet((3, 4, 23, 3), True)
ResNet152 = _resnet((3, 8, 36, 3), True)
ResNeXt50 = _resnet((3, 4, 6, 3), True, groups=32, base_width=4)
ResNeXt101 = _resnet((3, 4, 23, 3), True, groups=32, base_width=8)
ResNeXt152 = _resnet((3, 8, 36, 3), True, groups=32, base_width=8)
WideResNet50 = _resnet((3, 4, 6, 3), True, base_width=128)
WideResNet101 = _resnet((3, 4, 23, 3), True, base_width=128)

# reference / torchvision spellings
ResNeXt50_32x4d = ResNeXt50
ResNeXt101_32x8d = ResNeXt101
ResNeXt152_32x8d = ResNeXt152
WideResNet50_2 = WideResNet50
WideResNet101_2 = WideResNet101

_RESNETS = {
    'ResNet18': ResNet18, 'ResNet34': ResNet34, 'ResNet50': ResNet50,
    'ResNet101': ResNet101, 'ResNet152': ResNet152, 'ResNeXt50': ResNeXt50,
    'ResNeXt101': ResNeXt101, 'ResNeXt152': ResNeXt152,
    'WideResNet50': WideResNet50, 'WideResNet101': WideResNet101,
    'ResNeXt50_32x4d': ResNeXt50, 'ResNeXt101_32x8d': ResNeXt101,
    'ResNeXt152_32x8d': ResNeXt152, 'WideResNet50_2': WideResNet50,
    'WideResNet101_2': WideResNet101,
}


def get_resnet(name: str, in_channels: int = None, **kwargs):
    """Look up a ResNet by name (case and underscores ignored). With
    ``in_channels`` the encoder is built; otherwise the constructor is returned."""
    norm = name.lower().replace('_', '')
    for key, fn in _RESNETS.items():
        if key.lower().replace('_', '') == norm:
            if in_channels is not None:
                return fn(in_channels, **kwargs)
            if kwargs:
                raise ValueError('get_resnet kwargs require in_channels')
            return fn
    raise KeyError(f'Unknown ResNet: {name}. Available: {sorted(_RESNETS)}')
