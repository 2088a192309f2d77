"""Classical filter layers: depthwise convolutions with fixed or trainable kernels (NCHW).

Counterpart of ``celldetection_tpu/models/filters.py``: ``UpFilter2d``
(21-35), ``pascal_kernel`` and ``gaussian_kernel`` (38-51), ``Filter2d``
(54-83), the Pascal, Scharr, Sobel, Gaussian, box and Laplace kernels
(86-112) and ``EdgeFilter2d`` (115-129).

A trainable ``Filter2d`` keeps its kernel as the parameter ``weight`` in
the JAX layout (``[kh, kw]``, or ``[num, kh, kw]`` for a stack of kernels),
which ``util.weights.state_dict_from_jax`` copies unchanged from a module
named as flax names a ``Filter2d`` (see ``util.weights._is_filter``), so
JAX weights load with ``strict=True``. A fixed kernel is a buffer outside
the state dict, as it is a constant in the JAX package.
"""
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ['Filter2d', 'PascalFilter2d', 'ScharrFilter2d', 'SobelFilter2d', 'GaussianFilter2d',
           'BoxFilter2d', 'LaplaceFilter2d', 'EdgeFilter2d', 'UpFilter2d',
           'pascal_kernel', 'gaussian_kernel']


def pascal_kernel(n: int) -> np.ndarray:
    """The outer product of the n-th row of Pascal's triangle, normalised (binomial smoothing)."""
    row = np.array([math.comb(n - 1, k) for k in range(n)], float)
    k = np.outer(row, row)
    return k / k.sum()


def gaussian_kernel(size: int, sigma: float = None) -> np.ndarray:
    """A normalised 2-D Gaussian of ``size`` taps (cv2's default sigma for the size)."""
    sigma = sigma or (0.3 * ((size - 1) * 0.5 - 1) + 0.8)
    ax = np.arange(size) - (size - 1) / 2
    g = np.exp(-0.5 * (ax / sigma) ** 2)
    k = np.outer(g, g)
    return k / k.sum()


class Filter2d(nn.Module):
    """Depthwise 2-D filter: the same kernel ``[kh, kw]`` on every input channel,
    or a stack ``[num, kh, kw]`` giving ``num`` output channels per input
    channel (channel ``g * num + n`` is input ``g`` under kernel ``n``)."""

    def __init__(self, kernel=None, trainable: bool = False, padding: Optional[int] = None,
                 stride: int = 1):
        super().__init__()
        k = torch.as_tensor(np.asarray(kernel, np.float32))
        self.trainable = trainable
        self.padding = padding
        self.stride = stride
        if trainable:
            self.weight = nn.Parameter(k)
        else:
            self.register_buffer('fixed_kernel', k, persistent=False)

    @property
    def kernel(self) -> torch.Tensor:
        return self.weight if self.trainable else self.fixed_kernel

    def forward(self, x):
        k = self.kernel.to(x.dtype)
        c = x.shape[1]
        kh = k.shape[-2]
        pad = kh // 2 if self.padding is None else self.padding
        weight = k.expand(c, *k.shape)[:, None] if k.dim() == 2 else k.repeat(c, 1, 1)[:, None]
        return F.conv2d(x, weight, stride=self.stride, padding=pad, groups=c)


def PascalFilter2d(n: int = 5, **kwargs):
    return Filter2d(kernel=pascal_kernel(n), **kwargs)


def ScharrFilter2d(transpose: bool = False, **kwargs):
    k = np.array([[3., 0., -3.], [10., 0., -10.], [3., 0., -3.]])
    return Filter2d(kernel=(k.T if transpose else k), **kwargs)


def SobelFilter2d(transpose: bool = False, **kwargs):
    k = np.array([[1., 0., -1.], [2., 0., -2.], [1., 0., -1.]])
    return Filter2d(kernel=(k.T if transpose else k), **kwargs)


def GaussianFilter2d(size: int = 5, sigma: float = None, **kwargs):
    return Filter2d(kernel=gaussian_kernel(size, sigma), **kwargs)


def BoxFilter2d(size: int = 3, **kwargs):
    return Filter2d(kernel=np.full((size, size), 1. / size ** 2), **kwargs)


def LaplaceFilter2d(diagonal: bool = False, **kwargs):
    if diagonal:
        k = np.array([[1., 1., 1.], [1., -8., 1.], [1., 1., 1.]])
    else:
        k = np.array([[0., 1., 0.], [1., -4., 1.], [0., 1., 0.]])
    return Filter2d(kernel=k, **kwargs)


class UpFilter2d(nn.Module):
    """Image-pyramid upsampling: zeros injected by ``scale_factor``, then
    ``module`` (a ``PascalFilter2d()`` by default)."""

    def __init__(self, module: nn.Module = None, scale_factor: int = 2):
        super().__init__()
        self.module = module if module is not None else PascalFilter2d()
        self.scale_factor = scale_factor

    def forward(self, x):
        n, c, h, w = x.shape
        s = self.scale_factor
        up = x.new_zeros((n, c, h * s, w * s))
        up[:, :, ::s, ::s] = x
        return self.module(up)


class EdgeFilter2d(nn.Module):
    """Gradient magnitude ``sqrt(gx^2 + gy^2 + 1e-12)`` of a Scharr or Sobel
    pair, or the two gradients concatenated on the channels."""

    def __init__(self, magnitude: bool = True, method: str = 'scharr'):
        super().__init__()
        self.magnitude = magnitude
        self.method = method
        ctor = ScharrFilter2d if method == 'scharr' else SobelFilter2d
        self.fx, self.fy = ctor(), ctor(transpose=True)

    def forward(self, x):
        gx, gy = self.fx(x), self.fy(x)
        if self.magnitude:
            return torch.sqrt(gx ** 2 + gy ** 2 + 1e-12)
        return torch.cat([gx, gy], 1)
