"""timm encoders as ``nn.Module``s (optional dependency).

Counterpart of ``celldetection_tpu/models/timmodels.py`` (``TimmEncoder``
over ``timm.create_model(features_only=True)``). timm is imported when an
encoder is built, and a missing timm raises ``ImportError`` naming it.
"""
from typing import Dict, Optional, Sequence

import torch
from torch import nn

__all__ = ['TimmEncoder', 'get_timm_names']


def get_timm_names(filter: str = ''):
    """timm's model names (needs timm)."""
    import timm
    return timm.list_models(f'*{filter}*') if filter else timm.list_models()


class TimmEncoder(nn.Module):
    """A timm feature extractor with the encoder interface (``out_channels``,
    ``out_strides``, NCHW input to a dict of NCHW maps, key '0' finest)."""

    def __init__(self, model_name: str, in_channels: int = 3, pretrained: bool = False,
                 out_indices: Optional[Sequence[int]] = None, **kwargs):
        super().__init__()
        try:
            import timm
        except ImportError as e:
            raise ImportError(f'the encoder {model_name!r} needs the optional package timm, '
                              f'which is not installed; the native encoders (the names of '
                              f'models.host_encoder.NATIVE_ENCODER_NAMES) need nothing') from e
        self.module = timm.create_model(model_name, features_only=True, in_chans=in_channels,
                                        pretrained=pretrained, out_indices=out_indices, **kwargs)
        self.out_channels = list(self.module.feature_info.channels())
        self.out_strides = list(self.module.feature_info.reduction())

    def forward(self, x) -> Dict[str, torch.Tensor]:
        return {str(i): f for i, f in enumerate(self.module(x))}
