"""Normalization ops. Counterpart of ``celldetection_tpu/ops/normalization.py``."""
import torch

__all__ = ['pixel_norm']


def pixel_norm(x: torch.Tensor, axis: int = -1, eps: float = 1e-8) -> torch.Tensor:
    """GAN-style pixel normalization over ``axis``: ``x * rsqrt(mean(x^2) + eps)``
    (the channel axis; -1 for channels-last input as in the JAX package)."""
    return x * torch.rsqrt(x.square().mean(dim=axis, keepdim=True) + eps)
