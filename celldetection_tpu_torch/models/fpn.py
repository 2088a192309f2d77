"""Feature Pyramid Network (``nn.Module``s, NCHW inside).

Counterpart of ``celldetection_tpu/models/fpn.py``: ``FeaturePyramidNetwork``
(25-57), ``BackboneWithFPN`` (60-82), ``FPN`` (85-87), ``_res_fpn`` (100-111),
``_enc_fpn`` (114-119), the two MobileNetV3 FPNs (124-125) and the ten
ResNet-family FPNs (129-138).

Top-down: a 1x1 inner ``ConvNorm`` per level, nearest upsample and add, a
3x3 layer ``ConvNorm``, and an extra level ``'pool'``, a max-pool of kernel 1
and stride 2 of the coarsest output, at the maps' rank. Module names are the
reference layout (``fpn.inner_blocks.<i>.0``, ``fpn.layer_blocks.<i>.0``).
Every module takes ``nd`` (3 for NCDHW volumes); the constructors read it
from their arguments or from ``backbone_kwargs``.
"""
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.commons import interpolate_nchw
from . import mobilenetv3 as mnv3_lib
from . import resnet as resnet_lib
from .commons import ConvNorm, Normalize
from .unet import warn_dropped_pretrained

__all__ = ['FeaturePyramidNetwork', 'BackboneWithFPN', 'FPN', 'ResNet18FPN', 'ResNet34FPN',
           'ResNet50FPN', 'ResNet101FPN', 'ResNet152FPN', 'ResNeXt50FPN', 'ResNeXt101FPN',
           'ResNeXt152FPN', 'WideResNet50FPN', 'WideResNet101FPN', 'MobileNetV3LargeFPN',
           'MobileNetV3SmallFPN']


class FeaturePyramidNetwork(nn.Module):
    """FPN decoder over a dict of features (finest first).

    ``norm_layer`` defaults to None: plain convolutions with bias, the
    reference's torchvision-style FPN.
    """

    def __init__(self, in_channels_list: Sequence[int], out_channels: int = 256,
                 norm_layer: Optional[str] = None, extra_maxpool: bool = True, nd: int = 2):
        super().__init__()
        self.extra_maxpool = extra_maxpool
        self.inner_blocks = nn.ModuleList(
            ConvNorm(c, out_channels, 1, padding=0, norm_layer=norm_layer, nd=nd)
            for c in in_channels_list)
        self.layer_blocks = nn.ModuleList(
            ConvNorm(out_channels, out_channels, 3, norm_layer=norm_layer, nd=nd)
            for _ in in_channels_list)

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        names = list(x.keys())
        feats = list(x.values())
        last_inner = self.inner_blocks[-1](feats[-1])
        results = [self.layer_blocks[-1](last_inner)]
        for i in range(len(feats) - 2, -1, -1):
            inner = self.inner_blocks[i](feats[i])
            last_inner = inner + interpolate_nchw(last_inner, inner.shape[2:], 'nearest')
            results.insert(0, self.layer_blocks[i](last_inner))
        out = dict(zip(names, results))
        if self.extra_maxpool:
            pool = F.max_pool2d if results[-1].dim() == 4 else F.max_pool3d
            out['pool'] = pool(results[-1], 1, 2)
        return out


class BackboneWithFPN(nn.Module):
    """Normalize → encoder ``body`` → ``fpn``."""

    def __init__(self, body: nn.Module, out_channels: int = 256, normalize: bool = True,
                 inputs_mean=0., inputs_std=1., norm_layer: Optional[str] = None, nd: int = 2):
        super().__init__()
        self.normalize = Normalize(inputs_mean, inputs_std) if normalize else None
        self.body = body
        self.fpn = FeaturePyramidNetwork(body.out_channels, out_channels, norm_layer, nd=nd)
        self.out_channels = out_channels

    @property
    def feature_channels(self):
        """Channels per output key: the encoder's levels, then ``'pool'``."""
        return [self.out_channels] * (len(self.body.out_channels) + 1)

    def forward(self, inputs):
        x = inputs if self.normalize is None else self.normalize(inputs)
        return self.fpn(self.body(x))


def FPN(backbone: nn.Module, channels: int = 256, **kwargs):
    """FPN over an arbitrary encoder."""
    return BackboneWithFPN(body=backbone, out_channels=channels, **kwargs)


def _res_fpn(resnet_ctor):
    def ctor(in_channels, fpn_channels: int = 256, backbone_kwargs: dict = None,
             pretrained=False, **kwargs):
        # the second positional is the FPN width; the CPN zoo passes 0 there
        # (the UNets' out_channels), which means the default
        warn_dropped_pretrained(pretrained)
        bk = dict(fused_initial=False)
        bk.update(backbone_kwargs or {})
        bk['nd'] = kwargs.pop('nd', bk.get('nd', 2))
        return FPN(resnet_ctor(in_channels, **bk), channels=fpn_channels or 256, nd=bk['nd'],
                   **kwargs)
    return ctor


def _enc_fpn(encoder_ctor):
    def ctor(in_channels, fpn_channels: int = 256, backbone_kwargs: dict = None,
             pretrained=False, **kwargs):
        warn_dropped_pretrained(pretrained)
        bk = dict(backbone_kwargs or {})
        bk['nd'] = kwargs.pop('nd', bk.get('nd', 2))
        return FPN(encoder_ctor(in_channels, **bk), channels=fpn_channels or 256, nd=bk['nd'],
                   **kwargs)
    return ctor


MobileNetV3LargeFPN = _enc_fpn(mnv3_lib.MobileNetV3Large)
MobileNetV3SmallFPN = _enc_fpn(mnv3_lib.MobileNetV3Small)
ResNet18FPN = _res_fpn(resnet_lib.ResNet18)
ResNet34FPN = _res_fpn(resnet_lib.ResNet34)
ResNet50FPN = _res_fpn(resnet_lib.ResNet50)
ResNet101FPN = _res_fpn(resnet_lib.ResNet101)
ResNet152FPN = _res_fpn(resnet_lib.ResNet152)
ResNeXt50FPN = _res_fpn(resnet_lib.ResNeXt50)
ResNeXt101FPN = _res_fpn(resnet_lib.ResNeXt101)
ResNeXt152FPN = _res_fpn(resnet_lib.ResNeXt152)
WideResNet50FPN = _res_fpn(resnet_lib.WideResNet50)
WideResNet101FPN = _res_fpn(resnet_lib.WideResNet101)
