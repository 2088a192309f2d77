"""MA-Net: Multi-scale Attention Network (``nn.Module``s, NCHW inside).

Counterpart of ``celldetection_tpu/models/manet.py``:
``PositionWiseAttention`` (the PAB, 23-48), ``MultiscaleFusionAttention``
(the MFAB, 51-85), ``MaNetDecoder`` (88-115) and ``MaNet`` (118-137). The
deepest encoder level passes through the PAB; the decoder merges top-down
with MFABs (two squeeze-excitation gates, on the upsampled map and on the
lateral); the finest decoder level is resized bilinearly to the input.

Module names are the JAX package's (``decoder.pab.{in_conv,proj_a,proj_b,
proj,out_conv,beta}``, ``decoder.mfab<i>.{in0,in1,se_high_fc0,se_high_fc1,
se_low_fc0,se_low_fc1,out0,out1}``), so a key is the flax path joined by
dots. The PAB's softmax runs over all ``hw * hw`` affinities of an image at
once, as the JAX package's does (``p.reshape(n, -1)``), not row by row; its
two products are plain batched matmuls.
"""
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..ops.commons import interpolate_nchw
from .commons import ConvNormRelu, Normalize

__all__ = ['PositionWiseAttention', 'MultiscaleFusionAttention', 'MaNetDecoder', 'MaNet']


class PositionWiseAttention(nn.Module):
    """PAB: softmax position-affinity attention over the flattened spatial dims."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 mid_channels: int = 64, kernel_size: int = 3, beta: bool = False):
        super().__init__()
        c_out = out_channels or in_channels
        self.in_conv = nn.Conv2d(in_channels, c_out, 3, padding=1) \
            if in_channels != c_out else None
        self.proj_a = nn.Conv2d(c_out, mid_channels, 1)
        self.proj_b = nn.Conv2d(c_out, mid_channels, 1)
        self.proj = nn.Conv2d(c_out, c_out, kernel_size, padding=kernel_size // 2)
        self.out_conv = nn.Conv2d(c_out, c_out, 3, padding=1)
        self.beta = nn.Parameter(torch.zeros(1)) if beta else None

    def forward(self, x):
        if self.in_conv is not None:
            x = self.in_conv(x)
        n, c, h, w = x.shape
        a = self.proj_a(x).flatten(2).transpose(1, 2)             # [n, hw, mid]
        b = self.proj_b(x).flatten(2)                             # [n, mid, hw]
        p = torch.bmm(a, b)                                       # [n, i, j]
        p = torch.softmax(p.reshape(n, -1), -1).reshape(n, h * w, h * w)
        cmap = self.proj(x).flatten(2)                            # [n, c, hw]
        out = torch.bmm(cmap, p).reshape(n, c, h, w)              # out[c, j] = sum_i cmap[c, i] p[i, j]
        if self.beta is not None:
            out = self.beta * out
        return self.out_conv(out + x)


class MultiscaleFusionAttention(nn.Module):
    """MFAB: conv in, the two SE gates with the lateral, concatenate, conv out."""

    def __init__(self, in_channels: int, out_channels: int, lateral_channels: int,
                 compression: int = 16, interpolation: str = 'nearest'):
        super().__init__()
        self.interpolation = interpolation
        self.in0 = ConvNormRelu(in_channels, in_channels, use_bias=False)
        self.in1 = ConvNormRelu(in_channels, lateral_channels, kernel_size=1, padding=0,
                                use_bias=False)
        sq = max(lateral_channels // compression, 1)
        for name in ('se_high', 'se_low'):
            setattr(self, f'{name}_fc0', nn.Conv2d(lateral_channels, sq, 1))
            setattr(self, f'{name}_fc1', nn.Conv2d(sq, lateral_channels, 1))
        self.out0 = ConvNormRelu(2 * lateral_channels, out_channels, use_bias=False)
        self.out1 = ConvNormRelu(out_channels, out_channels, use_bias=False)

    def _se(self, y, name):
        s = getattr(self, f'{name}_fc0')(y.mean((2, 3), keepdim=True))
        return torch.sigmoid(getattr(self, f'{name}_fc1')(torch.relu(s)))

    def forward(self, x, lateral=None):
        x = self.in1(self.in0(x))
        if lateral is not None:
            mode = 'nearest' if self.interpolation == 'nearest' else 'bilinear'
            x = interpolate_nchw(x, lateral.shape[2:], mode)
            x = x * (self._se(x, 'se_high') + self._se(lateral, 'se_low'))
            x = torch.cat((x, lateral), 1)
        return self.out1(self.out0(x))


class MaNetDecoder(nn.Module):
    """The PAB on the deepest level, then MFAB top-down decoding."""

    def __init__(self, in_channels_list: Sequence[int],
                 out_channels_list: Optional[Sequence[int]] = None, pab_channels: int = 64,
                 keep_features: bool = True):
        super().__init__()
        in_list = list(in_channels_list)
        out_list = list(out_channels_list or in_list)
        self.keep_features = keep_features
        self.pab = PositionWiseAttention(in_list[-1], mid_channels=pab_channels) \
            if pab_channels else None
        top = in_list[-1]
        for i in range(len(in_list) - 2, -1, -1):
            setattr(self, f'mfab{i}', MultiscaleFusionAttention(top, out_list[i], in_list[i]))
            top = out_list[i]
        self.depth = len(in_list)

    def forward(self, x: Dict[str, torch.Tensor], size=None):
        names, feats = list(x.keys()), list(x.values())
        if self.pab is not None:
            feats[-1] = self.pab(feats[-1])
        last_inner = feats[-1]
        results = [last_inner]
        for i in range(len(feats) - 2, -1, -1):
            last_inner = getattr(self, f'mfab{i}')(last_inner, feats[i])
            results.insert(0, last_inner)
        out = {'out': last_inner if size is None else
               interpolate_nchw(last_inner, size, 'bilinear')}
        out.update(zip(names, results))
        if self.keep_features:
            out.update({f'encoder.{k}': v for k, v in x.items()})
        return out


class MaNet(nn.Module):
    """Encoder ``body`` + MA-Net ``decoder`` + input normalization (NCHW input)."""

    def __init__(self, body: nn.Module, pab_channels: int = 64, normalize: bool = True,
                 inputs_mean=0., inputs_std=1.):
        super().__init__()
        self.normalize = Normalize(inputs_mean, inputs_std) if normalize else None
        self.body = body
        self.decoder = MaNetDecoder(list(body.out_channels), pab_channels=pab_channels)

    @property
    def feature_channels(self):
        return list(self.body.out_channels)

    def forward(self, inputs):
        x = inputs if self.normalize is None else self.normalize(inputs)
        return self.decoder(self.body(x), size=inputs.shape[2:])
