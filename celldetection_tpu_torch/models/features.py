"""Multiscale basic features: an intensity, edge and texture bank (NCHW).

Counterpart of ``celldetection_tpu/models/features.py``: ``texture_filter``
(18-34) and ``MultiscaleBasicFeatures`` (37-57).
"""
from typing import Sequence

import torch
from torch import nn

from .filters import GaussianFilter2d, SobelFilter2d

__all__ = ['texture_filter', 'MultiscaleBasicFeatures']


def texture_filter(gaussian_filtered: torch.Tensor) -> torch.Tensor:
    """The Hessian's two eigenvalues per pixel of NCHW input, larger first:
    ``2 C`` channels, ``[e1 of every channel, e2 of every channel]``.

    The derivatives are ``jnp.gradient``'s: central differences inside,
    one-sided first-order differences at the edges.
    """
    g = gaussian_filtered
    gy, gx = torch.gradient(g, dim=(2, 3), edge_order=1)
    gyy, gyx = torch.gradient(gy, dim=(2, 3), edge_order=1)
    gxy, gxx = torch.gradient(gx, dim=(2, 3), edge_order=1)
    tr = gxx + gyy
    det = gxx * gyy - gxy * gyx
    disc = torch.sqrt(torch.clamp(tr ** 2 / 4 - det, min=0))
    return torch.cat([tr / 2 + disc, tr / 2 - disc], 1)


class MultiscaleBasicFeatures(nn.Module):
    """Per Gaussian scale: the smoothed image, its Sobel gradient magnitude
    and its Hessian eigenvalues, concatenated on the channels."""

    def __init__(self, sigmas: Sequence[float] = (0.5, 1.0, 2.0, 4.0), intensity: bool = True,
                 edges: bool = True, texture: bool = True):
        super().__init__()
        self.intensity, self.edges, self.texture = intensity, edges, texture
        self.gaussians = nn.ModuleList(
            GaussianFilter2d(size=max(3, int(2 * round(3 * sigma) + 1)), sigma=sigma)
            for sigma in sigmas)
        self.sobel_x, self.sobel_y = SobelFilter2d(), SobelFilter2d(transpose=True)

    def forward(self, x):
        outs = []
        for gaussian in self.gaussians:
            g = gaussian(x)
            if self.intensity:
                outs.append(g)
            if self.edges:
                gx, gy = self.sobel_x(g), self.sobel_y(g)
                outs.append(torch.sqrt(gx ** 2 + gy ** 2 + 1e-12))
            if self.texture:
                outs.append(texture_filter(g))
        return torch.cat(outs, 1)
