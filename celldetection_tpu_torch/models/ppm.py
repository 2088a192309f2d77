"""Pyramid Pooling Module (PSPNet-style), NCHW.

Counterpart of ``celldetection_tpu/models/ppm.py:17-33``. Each scale ``s``
average-pools with window and stride ``max(side // s, 1)``, as the JAX
package does (not ``adaptive_avg_pool2d``): the pooled side is
``floor(side / (side // s))``. A 1x1 ``ConvNormRelu`` (``scale<i>``), a
bilinear resize back, and the input concatenated first.
"""
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.commons import interpolate_nchw
from .commons import ConvNormRelu

__all__ = ['Ppm']


class Ppm(nn.Module):
    """Pool at several scales, 1x1 conv, upsample, concatenate with the input."""

    def __init__(self, in_channels: int, out_channels: int = 64,
                 scales: Sequence[int] = (1, 2, 3, 6)):
        super().__init__()
        self.scales = tuple(scales)
        for i in range(len(self.scales)):
            setattr(self, f'scale{i}', ConvNormRelu(in_channels, out_channels, kernel_size=1,
                                                    padding=0))
        self.out_channels = in_channels + len(self.scales) * out_channels

    def forward(self, x):
        spatial = tuple(x.shape[2:])
        outs = [x]
        for i, s in enumerate(self.scales):
            win = tuple(max(d // s, 1) for d in spatial)
            pooled = getattr(self, f'scale{i}')(F.avg_pool2d(x, win, win))
            outs.append(interpolate_nchw(pooled, spatial, 'bilinear'))
        return torch.cat(outs, 1)
