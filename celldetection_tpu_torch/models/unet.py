"""U-Net family (``nn.Module``s, NCHW inside).

Counterpart of ``celldetection_tpu/models/unet.py``: ``UNetEncoder`` (28-67),
``GeneralizedUNet`` (70-190), ``BackboneAsUNet``/``UNet`` (198-249),
``_make_encoder_unet`` (258-272), ``U22`` (275-278) and ``U12`` (299-302).

Module names follow the reference torch layout (``body.<i>``,
``unet.inner_blocks.<i>``, ``unet.layer_blocks.<i>``) so that weights from
``util.weights.state_dict_from_jax`` load with ``strict=True``.
"""
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..ops.commons import interpolate_nchw
from .commons import Normalize, TwoConvNormRelu, get_activation

__all__ = ['UNetEncoder', 'GeneralizedUNet', 'BackboneAsUNet', 'UNet', 'U22', 'U12']


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
    Stride bridging (encoders whose first stride exceeds 1) belongs to the
    ResNeXt slice and raises here.
    """

    def __init__(self, in_channels_list: Sequence[int], out_channels: int = 0, block_cls=None,
                 block_kwargs: Optional[dict] = None, final_activation=None,
                 interpolate: str = 'nearest', in_strides_list: Optional[Sequence[int]] = None,
                 out_channels_list: Optional[Sequence[int]] = None, keep_features: bool = True):
        super().__init__()
        if in_strides_list is not None and in_strides_list[0] > 1:
            raise NotImplementedError('GeneralizedUNet stride bridging (first stride > 1) '
                                      'is not ported yet: it comes with the ResNeXt slice')
        block_cls = block_cls or TwoConvNormRelu
        block_kwargs = block_kwargs or {}
        in_list = list(in_channels_list)
        out_list = list(out_channels_list) if out_channels_list is not None else list(in_list)
        self.out_channels_list = out_list
        self.interpolate = interpolate
        self.keep_features = keep_features
        depth = len(in_list) - 1
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
            self.layer_blocks[str(i)] = block_cls(in_list[i] + top_down, out_list[i],
                                                  **block_kwargs)
        self.out_layer = nn.Conv2d(out_list[0], out_channels, 1) if out_channels > 0 else None
        self.final_activation = None if final_activation is None else \
            get_activation(final_activation)

    def forward(self, x: Dict[str, torch.Tensor], size=None):
        names = list(x.keys())
        feats = list(x.values())
        last_inner = feats[-1]
        results = [last_inner]
        for i in range(len(feats) - 2, -1, -1):
            lateral = feats[i]
            top_down = last_inner
            if str(i) in self.inner_blocks:
                top_down = self.inner_blocks[str(i)](top_down)
            top_down = interpolate_nchw(top_down, lateral.shape[2:],
                                        'nearest' if self.interpolate == 'nearest' else 'bilinear')
            last_inner = self.layer_blocks[str(i)](torch.cat([lateral, top_down], 1))
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


def U12(in_channels, out_channels=0, final_activation=None, backbone_kwargs=None, **kwargs):
    """U-Net 12: 3 resolutions, base 64 channels."""
    return _make_encoder_unet(in_channels, out_channels, 64, 3, None, final_activation,
                              backbone_kwargs, **kwargs)
