"""DenseNet encoders (``nn.Module``s, NCHW inside).

Counterpart of ``celldetection_tpu/models/densenet.py``: ``_DenseLayer``
(18-32), ``_DenseBlock`` (35-45), ``_Transition`` (48-57),
``DenseNetEncoder`` (60-99) and 121/161/169/201 (102-112). A multi-scale
encoder: the features of each dense block, before its transition.

Module names are the JAX package's (torchvision's, with each norm's
parameters one level down in ``norm``): ``conv0``, ``norm0.norm``,
``denseblock<i>.denselayer<j>.{norm1.norm,conv1,norm2.norm,conv2}``,
``transition<i>.{norm.norm,conv}``.
"""
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .commons import NamedNorm

__all__ = ['DenseNet', 'DenseNetEncoder', 'DenseNet121', 'DenseNet161', 'DenseNet169',
           'DenseNet201']


class _DenseLayer(nn.Module):
    def __init__(self, in_channels: int, growth_rate: int, bn_size: int = 4):
        super().__init__()
        self.norm1 = NamedNorm(in_channels)
        self.conv1 = nn.Conv2d(in_channels, bn_size * growth_rate, 1, bias=False)
        self.norm2 = NamedNorm(bn_size * growth_rate)
        self.conv2 = nn.Conv2d(bn_size * growth_rate, growth_rate, 3, padding=1, bias=False)

    def forward(self, x):
        out = self.conv1(F.relu(self.norm1(x)))
        out = self.conv2(F.relu(self.norm2(out)))
        return torch.cat([x, out], 1)


class _DenseBlock(nn.Module):
    def __init__(self, num_layers: int, in_channels: int, growth_rate: int, bn_size: int = 4):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f'denselayer{i + 1}',
                    _DenseLayer(in_channels + i * growth_rate, growth_rate, bn_size))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f'denselayer{i + 1}')(x)
        return x


class _Transition(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm = NamedNorm(in_channels)
        self.conv = nn.Conv2d(in_channels, out_channels, 1, bias=False)

    def forward(self, x):
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2, 2)


class DenseNetEncoder(nn.Module):
    """DenseNet returning a dict of NCHW maps, key '0' finest (strides 4 to 32)."""

    def __init__(self, in_channels: int = 3, growth_rate: int = 32,
                 block_config: Sequence[int] = (6, 12, 24, 16), init_features: int = 64,
                 bn_size: int = 4):
        super().__init__()
        self.block_config = tuple(block_config)
        self.conv0 = nn.Conv2d(in_channels, init_features, 7, stride=2, padding=3, bias=False)
        self.norm0 = NamedNorm(init_features)
        c = init_features
        self.out_channels = []
        for i, n in enumerate(block_config):
            setattr(self, f'denseblock{i + 1}', _DenseBlock(n, c, growth_rate, bn_size))
            c += n * growth_rate
            self.out_channels.append(c)
            if i != len(block_config) - 1:
                setattr(self, f'transition{i + 1}', _Transition(c, c // 2))
                c //= 2
        self.out_strides = [4 * 2 ** i for i in range(len(block_config))]

    def forward(self, x) -> Dict[str, torch.Tensor]:
        if x.dim() != 4:
            raise NotImplementedError('3-D DenseNet inputs are not ported yet')
        x = F.max_pool2d(F.relu(self.norm0(self.conv0(x))), 3, 2, 1)
        features = {}
        for i in range(len(self.block_config)):
            x = getattr(self, f'denseblock{i + 1}')(x)
            features[str(i)] = x
            if i != len(self.block_config) - 1:
                x = getattr(self, f'transition{i + 1}')(x)
        return features


def _densenet(growth, config, init_feat):
    def ctor(in_channels, out_channels=0, pretrained=False, **kwargs):
        # the JAX package's constructors take no encoder options
        return DenseNetEncoder(in_channels=in_channels, growth_rate=growth, block_config=config,
                               init_features=init_feat)
    return ctor


# the reference's generic spelling: any growth rate and block configuration
DenseNet = DenseNetEncoder

DenseNet121 = _densenet(32, (6, 12, 24, 16), 64)
DenseNet161 = _densenet(48, (6, 12, 36, 24), 96)
DenseNet169 = _densenet(32, (6, 12, 32, 32), 64)
DenseNet201 = _densenet(32, (6, 12, 48, 32), 64)
