"""Normalization modules. Counterpart of ``celldetection_tpu/models/normalization.py``."""
from torch import nn

from ..ops.normalization import pixel_norm

__all__ = ['PixelNorm']


class PixelNorm(nn.Module):
    """GAN-style pixel normalization over the channels of NCHW input."""

    def __init__(self, eps: float = 1e-8):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        return pixel_norm(x, axis=1, eps=self.eps)
