"""segmentation-models-pytorch encoders as ``nn.Module``s (optional dependency).

Counterpart of ``celldetection_tpu/models/smp.py`` (``SmpEncoder`` over
``smp.encoders.get_encoder``). smp is imported when an encoder is built, and
a missing smp raises ``ImportError`` naming it.
"""
from typing import Dict, Optional

import torch
from torch import nn

__all__ = ['SmpEncoder']


class SmpEncoder(nn.Module):
    """An smp encoder with the encoder interface; the input level is left out."""

    def __init__(self, model_name: str, in_channels: int = 3, weights: Optional[str] = None,
                 depth: int = 5, **kwargs):
        super().__init__()
        try:
            import segmentation_models_pytorch as smp
        except ImportError as e:
            raise ImportError(f'the encoder {model_name!r} needs the optional package smp '
                              f'(segmentation-models-pytorch), which is not installed; the '
                              f'native encoders (the names of '
                              f'models.host_encoder.NATIVE_ENCODER_NAMES) need nothing') from e
        self.module = smp.encoders.get_encoder(model_name, in_channels=in_channels,
                                               weights=weights, depth=depth, **kwargs)
        self.out_channels = list(self.module.out_channels)[1:]
        self.out_strides = [2 ** i for i in range(1, len(self.out_channels) + 1)]

    def forward(self, x) -> Dict[str, torch.Tensor]:
        return {str(i): f for i, f in enumerate(self.module(x)[1:])}
