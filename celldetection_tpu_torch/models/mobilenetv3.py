"""MobileNetV3 encoders (``nn.Module``s, NCHW inside).

Counterpart of ``celldetection_tpu/models/mobilenetv3.py``: ``_make_divisible``
(28-32), ``_SqueezeExcitation`` (35-46), ``_InvertedResidual`` (49-82), the
torchvision tables (86-99), ``_scale_settings`` and ``_tail_settings``
(102-131), ``_MobileNetV3`` (134-187) and the constructors (190-204).

Features are collected before each stride-2 block; the deepest level passes
through the 1x1 ``lastconv`` (6x the last block's channels, hard-swish).
Batch norms take torchvision's eps 1e-3 and torch momentum 0.01 (flax's
0.99). ``width_mult`` scales channels by the divisible-by-8 rule,
``reduced_tail`` halves the last stage, ``dilated`` swaps the tail's
striding for dilation 2. Module names are the JAX package's (``stem``,
``stem_bn.norm``, ``block<i>.{expand,expand_bn.norm,dw,dw_bn.norm,se.fc1,
se.fc2,project,project_bn.norm}``, ``lastconv``, ``lastconv_bn.norm``).
``nd=3`` builds it for NCDHW volumes: every stride-2 block halves all three
spatial dims.
"""
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .commons import NamedNorm, conv_nd

__all__ = ['MobileNetV3Large', 'MobileNetV3Small', 'MobileNetV3Encoder']


def _bn(channels):
    return NamedNorm(channels, 'batchnorm2d', eps=1e-3, momentum=0.99)


def _make_divisible(v, divisor=8):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class _SqueezeExcitation(nn.Module):
    def __init__(self, channels: int, squeeze_channels: int, nd: int = 2):
        super().__init__()
        self.fc1 = conv_nd(nd)(channels, squeeze_channels, 1)
        self.fc2 = conv_nd(nd)(squeeze_channels, channels, 1)

    def forward(self, x):
        scale = self.fc2(F.relu(self.fc1(x.mean(tuple(range(2, x.dim())), keepdim=True))))
        return x * F.hardsigmoid(scale)


class _InvertedResidual(nn.Module):
    def __init__(self, in_channels, kernel, expanded, out_c, use_se, use_hs, stride, dilation=1,
                 nd=2):
        super().__init__()
        conv = conv_nd(nd)
        self.act = F.hardswish if use_hs else F.relu
        # torchvision: dilation replaces striding in the dilated tail
        stride = 1 if dilation > 1 else stride
        self.use_res = stride == 1 and in_channels == out_c
        if expanded != in_channels:
            self.expand = conv(in_channels, expanded, 1, bias=False)
            self.expand_bn = _bn(expanded)
        else:
            self.expand = self.expand_bn = None
        self.dw = conv(expanded, expanded, kernel, stride=stride,
                       padding=(kernel // 2) * dilation, dilation=dilation, groups=expanded,
                       bias=False)
        self.dw_bn = _bn(expanded)
        self.se = _SqueezeExcitation(expanded, _make_divisible(expanded // 4), nd) \
            if use_se else None
        self.project = conv(expanded, out_c, 1, bias=False)
        self.project_bn = _bn(out_c)

    def forward(self, x):
        out = x
        if self.expand is not None:
            out = self.act(self.expand_bn(self.expand(out)))
        out = self.act(self.dw_bn(self.dw(out)))
        if self.se is not None:
            out = self.se(out)
        out = self.project_bn(self.project(out))
        return x + out if self.use_res else out


# (kernel, expanded, out, SE, HS, stride): torchvision's tables
_LARGE = [
    (3, 16, 16, False, False, 1),
    (3, 64, 24, False, False, 2), (3, 72, 24, False, False, 1),
    (5, 72, 40, True, False, 2), (5, 120, 40, True, False, 1), (5, 120, 40, True, False, 1),
    (3, 240, 80, False, True, 2), (3, 200, 80, False, True, 1), (3, 184, 80, False, True, 1),
    (3, 184, 80, False, True, 1), (3, 480, 112, True, True, 1), (3, 672, 112, True, True, 1),
    (5, 672, 160, True, True, 2), (5, 960, 160, True, True, 1), (5, 960, 160, True, True, 1),
]
_SMALL = [
    (3, 16, 16, True, False, 2),
    (3, 72, 24, False, False, 2), (3, 88, 24, False, False, 1),
    (5, 96, 40, True, True, 2), (5, 240, 40, True, True, 1), (5, 240, 40, True, True, 1),
    (5, 120, 48, True, True, 1), (5, 144, 48, True, True, 1),
    (5, 288, 96, True, True, 2), (5, 576, 96, True, True, 1), (5, 576, 96, True, True, 1),
]


def _scale_settings(settings, width_mult: float):
    if width_mult == 1.0:
        return [tuple(s) for s in settings]
    adj = lambda c: _make_divisible(c * width_mult)   # noqa: E731
    return [(k, adj(e), adj(o)) + tuple(rest) for (k, e, o, *rest) in settings]


def _tail_settings(settings, reduced_tail: bool, dilated: bool):
    """torchvision's ``reduce_divider`` and ``dilation`` on the last stage
    (every entry from the final stride-2 block on): ``reduced_tail`` halves
    its output channels (and the expanded width after the boundary block),
    ``dilated`` gives it dilation 2 in place of the stride. Adds the
    dilation as a seventh field."""
    if not (reduced_tail or dilated):
        return [tuple(s) + (1,) for s in settings]
    last_s2 = max(i for i, s in enumerate(settings) if s[5] == 2)
    out = []
    for i, (k, e, o, se, hs, s) in enumerate(settings):
        dil = 1
        if i >= last_s2:
            if reduced_tail:
                o = o // 2
                if i > last_s2:
                    e = e // 2
            if dilated:
                dil = 2
        out.append((k, e, o, se, hs, s, dil))
    return out


class MobileNetV3Encoder(nn.Module):
    """MobileNetV3 returning a dict of NCHW maps, key '0' finest; a dilated
    tail keeps the previous level's stride."""

    def __init__(self, settings: Sequence[tuple] = tuple(_tail_settings(_LARGE, False, False)),
                 in_channels: int = 3, stem_channels: int = 16, nd: int = 2):
        super().__init__()
        self.settings = [tuple(s) for s in settings]
        self.stem = conv_nd(nd)(in_channels, stem_channels, 3, stride=2, padding=1, bias=False)
        self.stem_bn = _bn(stem_channels)
        cur = stem_channels
        self.out_channels, self.out_strides, stride = [], [], 2
        for i, (k, e, o, se, hs, s, d) in enumerate(self.settings):
            if s == 2:
                self.out_channels.append(cur)
                self.out_strides.append(stride)
                stride *= 1 if d > 1 else 2
            setattr(self, f'block{i}', _InvertedResidual(cur, k, e, o, se, hs, s, d, nd))
            cur = o
        last = 6 * self.settings[-1][2]
        self.lastconv = conv_nd(nd)(cur, last, 1, bias=False)
        self.lastconv_bn = _bn(last)
        self.out_channels.append(last)
        self.out_strides.append(stride)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        x = F.hardswish(self.stem_bn(self.stem(x)))
        features = {}
        for i, s in enumerate(self.settings):
            if s[5] == 2:
                features[str(len(features))] = x
            x = getattr(self, f'block{i}')(x)
        features[str(len(features))] = F.hardswish(self.lastconv_bn(self.lastconv(x)))
        return features


def _mobilenet(settings):
    def ctor(in_channels, out_channels=0, pretrained=False, width_mult: float = 1.0,
             reduced_tail: bool = False, dilated: bool = False, nd: int = 2, **kwargs):
        conf = _scale_settings(_tail_settings(settings, reduced_tail, dilated), width_mult)
        stem = _make_divisible(16 * width_mult) if width_mult != 1.0 else 16
        return MobileNetV3Encoder(conf, in_channels=in_channels, stem_channels=stem, nd=nd)
    return ctor


MobileNetV3Large = _mobilenet(_LARGE)
MobileNetV3Small = _mobilenet(_SMALL)
