"""ConvNeXt and ConvNeXt V2 encoders (``nn.Module``s, NCHW between blocks).

Counterpart of ``celldetection_tpu/models/convnext.py``: ``GRN`` (24-37),
``CNBlock`` (40-66), ``CNBlockV2`` (69-71), ``ConvNeXtEncoder`` (74-133) and
the constructors Tiny to Large and V2 Atto to Huge (136-163).

Module names are the JAX package's (``stem_conv``, ``stem_norm``,
``down<i>_norm``, ``down<i>_conv``, ``stage<i>_block<j>`` with ``dwconv``,
``norm``, ``mlp0``, ``grn``, ``mlp1`` and ``layer_scale``), so a state-dict
key is the flax path joined by dots. A block runs its LayerNorm, MLP and GRN
channels-last, as the reference's torch version does with permutes; the
MLP's ``mlp0``/``mlp1`` are ``nn.Linear`` (flax ``Dense`` kernels
transposed). flax's ``Conv`` without a padding is ``'SAME'``: the 4x4/4 stem
and the 2x2/2 downsamples pad as it does (:func:`.commons.same_padding`), so
sides that the strides do not divide give the JAX package's shapes.
"""
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .commons import StochasticDepth, same_padding

__all__ = ['GRN', 'CNBlock', 'ConvNeXtEncoder', 'ConvNeXt', 'ConvNeXtV2', 'ConvNeXtTiny',
           'ConvNeXtSmall', 'ConvNeXtBase', 'ConvNeXtLarge', 'ConvNeXtV2Atto', 'ConvNeXtV2Femto',
           'ConvNeXtV2Pico', 'ConvNeXtV2Nano', 'ConvNeXtV2Tiny', 'ConvNeXtV2Base',
           'ConvNeXtV2Large', 'ConvNeXtV2Huge']


class GRN(nn.Module):
    """Global Response Normalization of channels-last input (ConvNeXt V2)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        gx = torch.sqrt(x.square().sum(dim=tuple(range(1, x.dim() - 1)), keepdim=True))
        nx = gx / (gx.mean(-1, keepdim=True) + self.eps)
        return self.gamma * (x * nx) + self.beta + x


class _ChannelLayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` over the channels of NCHW input (flax ``LayerNorm`` on NHWC)."""

    def forward(self, x):
        return super().forward(x.movedim(1, -1)).movedim(-1, 1)


class CNBlock(nn.Module):
    """ConvNeXt block: depthwise 7x7, LayerNorm (eps 1e-6), 4x MLP with exact
    GELU (and GRN in V2), layer scale, stochastic depth in train mode."""

    def __init__(self, channels: int, layer_scale: Optional[float] = 1e-6,
                 stochastic_depth_prob: float = 0., kernel_size: int = 7, v2: bool = False):
        super().__init__()
        self.dwconv = nn.Conv2d(channels, channels, kernel_size, padding=kernel_size // 2,
                                groups=channels)
        self.norm = nn.LayerNorm(channels, eps=1e-6)
        self.mlp0 = nn.Linear(channels, 4 * channels)
        self.grn = GRN(4 * channels) if v2 else None
        self.mlp1 = nn.Linear(4 * channels, channels)
        self.layer_scale = None if layer_scale is None else \
            nn.Parameter(torch.full((channels,), float(layer_scale)))
        self.drop = StochasticDepth(stochastic_depth_prob)

    def forward(self, x):
        out = self.dwconv(x).movedim(1, -1)
        out = F.gelu(self.mlp0(self.norm(out)))
        if self.grn is not None:
            out = self.grn(out)
        out = self.mlp1(out)
        if self.layer_scale is not None:
            out = out * self.layer_scale
        return x + self.drop(out.movedim(-1, 1))


class ConvNeXtEncoder(nn.Module):
    """ConvNeXt multi-scale encoder returning a dict of NCHW maps (key '0' finest).

    Args:
        depths: Blocks per stage.
        channels: Channels per stage.
        v2: GRN blocks without layer scale (ConvNeXt V2).
        fused_initial: The stem belongs to the first level (strides 4, 8,
            ...); otherwise it is a level of its own at stride 4 as well.
        stochastic_depth_prob: The last block's drop probability; block
            ``k`` of ``n`` drops with ``prob * k / (n - 1)``.
    """

    def __init__(self, in_channels: int = 3, depths: Sequence[int] = (3, 3, 9, 3),
                 channels: Sequence[int] = (96, 192, 384, 768),
                 stochastic_depth_prob: float = 0., layer_scale: float = 1e-6, v2: bool = False,
                 fused_initial: bool = True):
        super().__init__()
        self.depths, self.channels = tuple(depths), tuple(channels)
        self.fused_initial = fused_initial
        self.stem_conv = nn.Conv2d(in_channels, channels[0], 4, stride=4)
        self.stem_norm = _ChannelLayerNorm(channels[0], eps=1e-6)
        total, sid = sum(depths), 0
        for i, (depth, ch) in enumerate(zip(depths, channels)):
            if i > 0:
                setattr(self, f'down{i}_norm', _ChannelLayerNorm(channels[i - 1], eps=1e-6))
                setattr(self, f'down{i}_conv', nn.Conv2d(channels[i - 1], ch, 2, stride=2))
            for j in range(depth):
                sd = stochastic_depth_prob * sid / max(total - 1., 1.)
                setattr(self, f'stage{i}_block{j}',
                        CNBlock(ch, None if v2 else layer_scale, sd, v2=v2))
                sid += 1
        self.out_channels = ([] if fused_initial else [channels[0]]) + list(channels)
        self.out_strides = ([] if fused_initial else [4]) + \
            [4 * 2 ** i for i in range(len(channels))]

    def forward(self, x) -> Dict[str, torch.Tensor]:
        if x.dim() != 4:
            raise NotImplementedError('3-D ConvNeXt inputs are not ported yet')
        x = self.stem_norm(self.stem_conv(same_padding(x, 4, 4)))
        features = {}
        if not self.fused_initial:
            features['0'] = x
        for i, depth in enumerate(self.depths):
            if i > 0:
                x = getattr(self, f'down{i}_norm')(x)
                x = getattr(self, f'down{i}_conv')(same_padding(x, 2, 2))
            for j in range(depth):
                x = getattr(self, f'stage{i}_block{j}')(x)
            features[str(len(features))] = x
        return features


def _convnext(depths, channels, v2=False):
    def ctor(in_channels, out_channels=0, fused_initial=True, pretrained=False, **kwargs):
        kwargs.pop('nd', None)
        return ConvNeXtEncoder(in_channels=in_channels, depths=depths, channels=channels,
                               v2=v2, fused_initial=fused_initial, **kwargs)
    return ctor


# the reference's generic spellings: ConvNeXt(depths=..., channels=...)
ConvNeXt = ConvNeXtEncoder


def ConvNeXtV2(**kwargs):
    kwargs.setdefault('v2', True)
    return ConvNeXtEncoder(**kwargs)


ConvNeXtTiny = _convnext((3, 3, 9, 3), (96, 192, 384, 768))
ConvNeXtSmall = _convnext((3, 3, 27, 3), (96, 192, 384, 768))
ConvNeXtBase = _convnext((3, 3, 27, 3), (128, 256, 512, 1024))
ConvNeXtLarge = _convnext((3, 3, 27, 3), (192, 384, 768, 1536))

ConvNeXtV2Atto = _convnext((2, 2, 6, 2), (40, 80, 160, 320), v2=True)
ConvNeXtV2Femto = _convnext((2, 2, 6, 2), (48, 96, 192, 384), v2=True)
ConvNeXtV2Pico = _convnext((2, 2, 6, 2), (64, 128, 256, 512), v2=True)
ConvNeXtV2Nano = _convnext((2, 2, 8, 2), (80, 160, 320, 640), v2=True)
ConvNeXtV2Tiny = _convnext((3, 3, 9, 3), (96, 192, 384, 768), v2=True)
ConvNeXtV2Base = _convnext((3, 3, 27, 3), (128, 256, 512, 1024), v2=True)
ConvNeXtV2Large = _convnext((3, 3, 27, 3), (192, 384, 768, 1536), v2=True)
ConvNeXtV2Huge = _convnext((3, 3, 27, 3), (352, 704, 1408, 2816), v2=True)
