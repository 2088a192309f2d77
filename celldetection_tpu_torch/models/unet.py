"""U-Net family (``nn.Module``s, NCHW inside).

Counterpart of ``celldetection_tpu/models/unet.py``: ``UNetEncoder`` (28-67),
``GeneralizedUNet`` (70-190, with its stride bridging), ``BackboneAsUNet``/``UNet``
(198-249), ``_make_encoder_unet`` (258-272), ``U22``, ``SlimU22``,
``WideU22``, ``U17``, ``U12`` and ``ResUNet`` (275-308), ``_backbone_unet``
(311-343), the ten ResNet-family UNets (346-356) and the ConvNeXt, DenseNet
and MobileNetV3 UNets (366-377).

Module names follow the reference torch layout (``body.<i>``,
``unet.inner_blocks.<i>``, ``unet.layer_blocks.<i>``) so that weights from
``util.weights.state_dict_from_jax`` load with ``strict=True``.
"""
import warnings
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..ops.commons import interpolate_nchw
from . import convnext as convnext_lib
from . import densenet as densenet_lib
from . import mobilenetv3 as mnv3_lib
from . import resnet as resnet_lib
from .commons import Normalize, ResBlock, TwoConvNormRelu, get_activation

__all__ = ['UNetEncoder', 'GeneralizedUNet', 'BackboneAsUNet', 'UNet', 'U22', 'SlimU22',
           'WideU22', 'U17', 'U12', 'ResUNet', 'ResNet18UNet', 'ResNet34UNet', 'ResNet50UNet',
           'ResNet101UNet', 'ResNet152UNet', 'ResNeXt50UNet', 'ResNeXt101UNet',
           'ResNeXt152UNet', 'WideResNet50UNet', 'WideResNet101UNet', 'ConvNeXtTinyUNet',
           'ConvNeXtSmallUNet', 'ConvNeXtBaseUNet', 'ConvNeXtLargeUNet', 'ConvNeXtV2TinyUNet',
           'ConvNeXtV2BaseUNet', 'DenseNet121UNet', 'DenseNet161UNet', 'DenseNet169UNet',
           'DenseNet201UNet', 'MobileNetV3LargeUNet', 'MobileNetV3SmallUNet']


class UNetEncoder(nn.Sequential):
    """Plain U-Net encoder: ``depth`` stages, 2x max-pool between stages.

    ``body.0`` is the first block; ``body.<i>`` for i > 0 is
    ``Sequential(MaxPool2d, block)``, the reference layout. Stage i has
    ``base_channels * factor**i`` channels at stride ``2**i``.
    """

    def __init__(self, in_channels: int = 3, depth: int = 5, base_channels: int = 64,
                 factor: int = 2, block_cls=None, norm_layer: str = 'batchnorm2d'):
        block_cls = block_cls or TwoConvNormRelu
        out_channels = [base_channels * (factor ** i) for i in range(depth)]
        stages = []
        prev = in_channels
        for out_c in out_channels:
            block = block_cls(prev, out_c, norm_layer=norm_layer)
            stages.append(nn.Sequential(nn.MaxPool2d(2), block) if stages else block)
            prev = out_c
        super().__init__(*stages)
        self.out_channels = out_channels
        self.out_strides = [2 ** i for i in range(depth)]

    def forward(self, x) -> Dict[str, torch.Tensor]:
        features = {}
        for i, stage in enumerate(self):
            x = stage(x)
            features[str(i)] = x
        return features


class GeneralizedUNet(nn.Module):
    """U-Net decoder over a dict of multi-scale NCHW features (level 0 finest).

    Per level, top-down: the inner 1x1 conv reduces channels *before* the
    upsample (exact for nearest: a 1x1 conv commutes with a spatial convex
    combination), then concat with the lateral map and a ``block_cls``.
    Stride bridging: an encoder whose first stride is ``2**n > 1`` gets ``n``
    bridge levels above it, each a bias-free ``TwoConvNormRelu`` on the
    2x-upsampled top-down map. The output keys are the encoder's, finest
    first, so with bridges ``'0'`` names the stride-1 level and the deepest
    decoder level has no key (``zip`` truncates, as in the JAX package).
    """

    def __init__(self, in_channels_list: Sequence[int], out_channels: int = 0, block_cls=None,
                 block_kwargs: Optional[dict] = None, final_activation=None,
                 interpolate: str = 'nearest', in_strides_list: Optional[Sequence[int]] = None,
                 out_channels_list: Optional[Sequence[int]] = None, keep_features: bool = True):
        super().__init__()
        block_cls = block_cls or TwoConvNormRelu
        block_kwargs = block_kwargs or {}
        in_list, out_list, self.bridges = _plan(in_channels_list, out_channels_list,
                                                in_strides_list)
        self.in_list = in_list
        self.out_channels_list = out_list
        self.interpolate = interpolate
        self.keep_features = keep_features
        depth = len(in_list) - 1
        # a bridge inherits only the activation and the norm of block_kwargs
        bridge_kwargs = {k: v for k, v in block_kwargs.items()
                         if k in ('activation', 'norm_layer')}
        self.inner_blocks = nn.ModuleDict()
        self.layer_blocks = nn.ModuleDict()
        for i in range(depth - 1, -1, -1):
            inner_inc = out_list[i + 1] if i + 1 < depth else in_list[i + 1]
            inner_ouc = out_list[i]
            top_down = inner_inc
            if inner_inc > 0 and inner_ouc < inner_inc:
                # the JAX package's inner{i+1}, the reference's inner_blocks.<i>
                self.inner_blocks[str(i)] = nn.Conv2d(inner_inc, inner_ouc, 1)
                top_down = inner_ouc
            if in_list[i] > 0:
                self.layer_blocks[str(i)] = block_cls(in_list[i] + top_down, out_list[i],
                                                      **block_kwargs)
            else:
                self.layer_blocks[str(i)] = TwoConvNormRelu(top_down, out_list[i],
                                                            use_bias=False, **bridge_kwargs)
        self.out_layer = nn.Conv2d(out_list[0], out_channels, 1) if out_channels > 0 else None
        self.final_activation = None if final_activation is None else \
            get_activation(final_activation)

    def forward(self, x: Dict[str, torch.Tensor], size=None):
        names = list(x.keys())
        feats = list(x.values())
        mode = 'nearest' if self.interpolate == 'nearest' else 'bilinear'
        last_inner = feats[-1]
        results = [last_inner]
        for i in range(len(self.in_list) - 2, -1, -1):
            lateral = feats[i - self.bridges] if self.in_list[i] > 0 else None
            top_down = last_inner
            if str(i) in self.inner_blocks:
                top_down = self.inner_blocks[str(i)](top_down)
            t_size = lateral.shape[2:] if lateral is not None else \
                tuple(2 * s for s in top_down.shape[2:])
            top_down = interpolate_nchw(top_down, t_size, mode)
            block_in = top_down if lateral is None else torch.cat([lateral, top_down], 1)
            last_inner = self.layer_blocks[str(i)](block_in)
            results.insert(0, last_inner)
        final = results[0] if size is None else interpolate_nchw(last_inner, size, 'bilinear')
        if self.out_layer is not None:
            final = self.out_layer(final)
            return final if self.final_activation is None else self.final_activation(final)
        out = {'out': final}
        out.update(zip(names, results))
        if self.keep_features:
            out.update({f'encoder.{k}': v for k, v in x.items()})
        return out


def _plan(in_channels_list, out_channels_list=None, in_strides_list=None):
    """The decoder's levels: ``(in_list, out_list, bridges)``, where ``bridges``
    levels of 0 input channels precede the encoder's (``GeneralizedUNet._plan``
    of the JAX package)."""
    in_list = list(in_channels_list)
    out_list = list(out_channels_list) if out_channels_list is not None else list(in_list)
    first_stride = 1 if in_strides_list is None else int(in_strides_list[0])
    bridges = max(first_stride.bit_length() - 1, 0)   # floor(log2(first stride))
    num = len(in_list)
    for _ in range(bridges):
        in_list = [0] + in_list
        if len(out_list) < num + bridges - 1:
            out_list = [out_list[0]] + out_list
    return in_list, out_list, bridges


class BackboneAsUNet(nn.Module):
    """Encoder ``body`` + ``GeneralizedUNet`` decoder ``unet`` + input normalization.

    Takes NCHW input; returns the decoder's dict (or map, with ``out_channels``).
    """

    def __init__(self, body: nn.Module, in_channels_list: Sequence[int], out_channels: int = 0,
                 block_cls=None, block_kwargs: Optional[dict] = None, final_activation=None,
                 interpolate: str = 'nearest', in_strides_list: Optional[Sequence[int]] = None,
                 out_channels_list: Optional[Sequence[int]] = None, normalize: bool = True,
                 inputs_mean=0., inputs_std=1.):
        super().__init__()
        self.normalize = Normalize(inputs_mean, inputs_std) if normalize else None
        self.body = body
        self.unet = GeneralizedUNet(in_channels_list, out_channels, block_cls, block_kwargs,
                                    final_activation, interpolate, in_strides_list,
                                    out_channels_list)

    @property
    def feature_channels(self):
        """Per-key decoder output channels (key '0' = finest level)."""
        return self.unet.out_channels_list

    def forward(self, inputs):
        x = inputs if self.normalize is None else self.normalize(inputs)
        return self.unet(self.body(x), size=inputs.shape[2:])


class UNet(BackboneAsUNet):
    """U-Net over an arbitrary encoder."""


def _make_encoder_unet(in_channels, out_channels, base_channels, depth=5, block_cls=None,
                       final_activation=None, backbone_kwargs=None, **kwargs):
    bk = dict(backbone_kwargs or {})
    encoder = UNetEncoder(in_channels=in_channels, depth=bk.pop('depth', depth),
                          base_channels=bk.pop('base_channels', base_channels),
                          block_cls=block_cls, **bk)
    return UNet(body=encoder, in_channels_list=encoder.out_channels,
                in_strides_list=encoder.out_strides, out_channels=out_channels,
                block_cls=block_cls, final_activation=final_activation, **kwargs)


def U22(in_channels, out_channels=0, final_activation=None, backbone_kwargs=None, **kwargs):
    """U-Net 22: 22 convolutions over 5 resolutions, base 64 channels."""
    return _make_encoder_unet(in_channels, out_channels, 64, 5, None, final_activation,
                              backbone_kwargs, **kwargs)


def SlimU22(in_channels, out_channels=0, final_activation=None, backbone_kwargs=None,
            **kwargs):
    """U22 with half the channels (base 32)."""
    return _make_encoder_unet(in_channels, out_channels, 32, 5, None, final_activation,
                              backbone_kwargs, **kwargs)


def WideU22(in_channels, out_channels=0, final_activation=None, backbone_kwargs=None,
            **kwargs):
    """U22 with 1.5x the channels (base 96)."""
    return _make_encoder_unet(in_channels, out_channels, 96, 5, None, final_activation,
                              backbone_kwargs, **kwargs)


def U17(in_channels, out_channels=0, final_activation=None, backbone_kwargs=None, **kwargs):
    """U-Net 17: 4 resolutions, base 64 channels."""
    return _make_encoder_unet(in_channels, out_channels, 64, 4, None, final_activation,
                              backbone_kwargs, **kwargs)


def U12(in_channels, out_channels=0, final_activation=None, backbone_kwargs=None, **kwargs):
    """U-Net 12: 3 resolutions, base 64 channels."""
    return _make_encoder_unet(in_channels, out_channels, 64, 3, None, final_activation,
                              backbone_kwargs, **kwargs)


def ResUNet(in_channels, out_channels=0, final_activation=None, backbone_kwargs=None,
            **kwargs):
    """U22's shape with residual blocks (``ResBlock``) in encoder and decoder."""
    return _make_encoder_unet(in_channels, out_channels, 64, 5, ResBlock, final_activation,
                              backbone_kwargs, **kwargs)


def warn_dropped_pretrained(pretrained):
    """A bare backbone constructor does not apply ``pretrained``, as in the JAX package."""
    if pretrained:
        warnings.warn("pretrained=True on a bare backbone constructor is not applied: build the "
                      "CPN with backbone_kwargs={'pretrained': ...} (util.pretrained."
                      "apply_pretrained_ loads the weights after the init)", stacklevel=3)


def _backbone_unet(backbone_ctor, default_backbone_kwargs=None):
    """Encoder backbone + bridged UNet decoder.

    The ResNet-family UNets default to ``fused_initial=False``: the stem is
    its own stride-2 level feeding the decoder, as in the reference's
    ``_default_res_kwargs`` and the hosted reference checkpoints.
    """
    def ctor(in_channels, out_channels=0, final_activation=None, backbone_kwargs=None,
             pretrained=False, block_cls=None, **kwargs):
        warn_dropped_pretrained(pretrained)
        bk = dict(default_backbone_kwargs or {})
        bk.update(backbone_kwargs or {})
        encoder = backbone_ctor(in_channels, **bk)
        return UNet(body=encoder, in_channels_list=list(encoder.out_channels),
                    in_strides_list=list(encoder.out_strides), out_channels=out_channels,
                    block_cls=block_cls, final_activation=final_activation, **kwargs)
    return ctor


_RES_UNET_KW = dict(fused_initial=False)
ResNet18UNet = _backbone_unet(resnet_lib.ResNet18, _RES_UNET_KW)
ResNet34UNet = _backbone_unet(resnet_lib.ResNet34, _RES_UNET_KW)
ResNet50UNet = _backbone_unet(resnet_lib.ResNet50, _RES_UNET_KW)
ResNet101UNet = _backbone_unet(resnet_lib.ResNet101, _RES_UNET_KW)
ResNet152UNet = _backbone_unet(resnet_lib.ResNet152, _RES_UNET_KW)
ResNeXt50UNet = _backbone_unet(resnet_lib.ResNeXt50, _RES_UNET_KW)
ResNeXt101UNet = _backbone_unet(resnet_lib.ResNeXt101, _RES_UNET_KW)
ResNeXt152UNet = _backbone_unet(resnet_lib.ResNeXt152, _RES_UNET_KW)
WideResNet50UNet = _backbone_unet(resnet_lib.WideResNet50, _RES_UNET_KW)
WideResNet101UNet = _backbone_unet(resnet_lib.WideResNet101, _RES_UNET_KW)

ConvNeXtTinyUNet = _backbone_unet(convnext_lib.ConvNeXtTiny)
ConvNeXtSmallUNet = _backbone_unet(convnext_lib.ConvNeXtSmall)
ConvNeXtBaseUNet = _backbone_unet(convnext_lib.ConvNeXtBase)
ConvNeXtLargeUNet = _backbone_unet(convnext_lib.ConvNeXtLarge)
ConvNeXtV2TinyUNet = _backbone_unet(convnext_lib.ConvNeXtV2Tiny)
ConvNeXtV2BaseUNet = _backbone_unet(convnext_lib.ConvNeXtV2Base)
DenseNet121UNet = _backbone_unet(densenet_lib.DenseNet121)
DenseNet161UNet = _backbone_unet(densenet_lib.DenseNet161)
DenseNet169UNet = _backbone_unet(densenet_lib.DenseNet169)
DenseNet201UNet = _backbone_unet(densenet_lib.DenseNet201)
MobileNetV3LargeUNet = _backbone_unet(mnv3_lib.MobileNetV3Large)
MobileNetV3SmallUNet = _backbone_unet(mnv3_lib.MobileNetV3Small)
