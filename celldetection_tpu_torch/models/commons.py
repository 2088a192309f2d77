"""Building blocks (``nn.Module``s, NCHW inside).

Counterpart of ``celldetection_tpu/models/commons.py``: ``get_activation``
(105-114), ``Norm`` (117-150, batchnorm branch, inference and training),
``ConvNorm`` (203-221),
``TwoConvNormRelu`` (242-262), ``ScaledTanh`` (269-275), ``ReadOut``
(348-384), ``fused_head_conv`` and ``FusableReadOut`` (406-474), ``Normalize``
(503-522).

Submodules are ``nn.Sequential`` with the reference torch layout, so the
state-dict keys are the ones ``export_torch_state_dict`` emits
(``TwoConvNormRelu``: conv 0, norm 1, conv 3, norm 4; ``ReadOut.block``:
conv0 0, norm 1, conv1 4).
"""
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ['get_activation', 'Norm', 'ConvNorm', 'TwoConvNormRelu', 'ScaledTanh', 'Normalize',
           'Dropout2d', 'ReadOut', 'FusableReadOut', 'fused_head_conv']

BN_EPS = 1e-5
BN_MOMENTUM = 0.9    # flax's convention: running = momentum * running + (1 - momentum) * batch

_ACTIVATIONS = {
    'relu': nn.ReLU,
    'leakyrelu': lambda: nn.LeakyReLU(0.01),
    'gelu': lambda: nn.GELU(approximate='tanh'),   # jax.nn.gelu's default
    'sigmoid': nn.Sigmoid,
    'tanh': nn.Tanh,
    'softmax': lambda: nn.Softmax(dim=1),          # the channel axis of NCHW
    'silu': nn.SiLU,
    'swish': nn.SiLU,
    'elu': nn.ELU,
    'selu': nn.SELU,
    'mish': nn.Mish,
    'hardswish': nn.Hardswish,
    'hardsigmoid': nn.Hardsigmoid,
    'identity': nn.Identity,
    'none': nn.Identity,
}


def get_activation(activation) -> nn.Module:
    """Resolve an activation by name, module or None (identity) to a module."""
    if activation is None:
        return nn.Identity()
    if isinstance(activation, nn.Module):
        return activation
    key = str(activation).lower().replace('_', '').replace('2d', '')
    if key in _ACTIVATIONS:
        return _ACTIVATIONS[key]()
    raise ValueError(f'Unknown activation: {activation}')


class Norm(nn.Module):
    """Batch normalization, eps 1e-5, as flax's ``nn.BatchNorm``.

    In eval mode it normalises with the running statistics. In train mode
    it normalises with the batch's mean and biased variance and updates the
    running statistics the way flax does: ``BN_MOMENTUM`` (0.9) times the old
    value plus ``1 - momentum`` times the batch's mean and *biased* variance,
    computed as flax computes it, ``E[x^2] - E[x]^2`` (``F.batch_norm`` would
    store the unbiased variance).

    Parameters ``weight``/``bias`` and buffers ``running_mean``/``running_var``
    carry the reference names, without ``num_batches_tracked``, so the keys
    equal those of ``export_torch_state_dict``. The other norm kinds of the
    JAX ``Norm`` belong to later slices.
    """

    def __init__(self, num_features: int, kind: str = 'batchnorm2d', eps: float = BN_EPS):
        super().__init__()
        if not str(kind).lower().replace('_', '').startswith('batchnorm'):
            raise NotImplementedError(f'Norm {kind!r}: only batchnorm is ported')
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                training=False, eps=self.eps)
        with torch.no_grad():
            # flax's statistics: E[x^2] - E[x]^2, clipped at 0
            mean = x.mean((0, 2, 3))
            var = torch.clamp(x.square().mean((0, 2, 3)) - mean.square(), min=0.)
            m = BN_MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        # the native kernels, not cuDNN's: on an H100 full-width CpnU22 trained
        # 6% faster with them, and its float32 gradients came out closer to
        # float64's (chip_smoke.py phase 11a)
        return torch.ops.aten.native_batch_norm(x, self.weight, self.bias, None, None, True, 0.,
                                                self.eps)[0]


class ConvNorm(nn.Sequential):
    """Convolution + normalization; ``norm_layer=None`` is the convolution alone (the FPN's)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 padding: Optional[int] = None, stride: int = 1,
                 norm_layer: Optional[str] = 'batchnorm2d', use_bias: bool = True,
                 groups: int = 1):
        pad = kernel_size // 2 if padding is None else padding
        layers = [nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride, padding=pad,
                            bias=use_bias, groups=groups)]
        if norm_layer is not None:
            layers.append(Norm(out_channels, norm_layer))
        super().__init__(*layers)


class TwoConvNormRelu(nn.Sequential):
    """conv-norm-act x2 (the U-Net block), flat: conv 0, norm 1, act 2, conv 3, norm 4, act 5."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 padding: Optional[int] = None, stride: int = 1,
                 mid_channels: Optional[int] = None, norm_layer: str = 'batchnorm2d',
                 activation='relu', use_bias: bool = True):
        mid = out_channels if mid_channels is None else mid_channels
        super().__init__(
            *ConvNorm(in_channels, mid, kernel_size, padding, stride, norm_layer, use_bias),
            get_activation(activation),
            *ConvNorm(mid, out_channels, kernel_size, padding, 1, norm_layer, use_bias),
            get_activation(activation))


class ScaledTanh(nn.Module):
    """``tanh(x) * factor + shift``."""

    def __init__(self, factor: float, shift: float = 0.):
        super().__init__()
        self.factor = factor
        self.shift = shift

    def forward(self, x):
        return torch.tanh(x) * self.factor + self.shift


class Normalize(nn.Module):
    """``(clamp(x, *assert_range) - mean) / std`` over NCHW input.

    The JAX package clamps where the reference asserts; so does this port.
    ``mean``/``std`` are scalars or per-channel sequences.
    """

    def __init__(self, mean=0., std=1., assert_range=(0., 1.)):
        super().__init__()
        self.mean = mean
        self.std = std
        self.assert_range = assert_range

    def forward(self, x):
        if self.assert_range is not None:
            x = x.clamp(*self.assert_range)
        kw = dict(dtype=x.dtype, device=x.device)
        mean = torch.as_tensor(self.mean, **kw)
        std = torch.as_tensor(self.std, **kw)
        if mean.dim():
            mean = mean.reshape(-1, 1, 1)
        if std.dim():
            std = std.reshape(-1, 1, 1)
        return (x - mean) / std


class Dropout2d(nn.Module):
    """Whole-channel dropout of NCHW input in train mode, identity in eval mode.

    As flax's ``nn.Dropout`` with the spatial dims broadcast: each (image,
    channel) is kept with probability ``1 - p`` and then scaled by
    ``1 / (1 - p)``. The draw comes from ``generator`` (set for each call by
    :meth:`..models.cpn.CPN.forward_padded`; torch's default when None).
    """

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or not self.p:
            return x
        keep = 1. - self.p
        draw = torch.rand(x.shape[:2] + (1, 1), generator=self.generator, device=x.device)
        return torch.where(draw < keep, x / keep, 0.)


class ReadOut(nn.Module):
    """Dense prediction head: ``block`` = conv0, norm, act, dropout, 1x1 conv1.

    Dropout is :class:`Dropout2d`, or identity when 0.
    """

    def __init__(self, in_channels: int, channels_out: int, kernel_size: int = 3,
                 padding: Optional[int] = None, activation='relu', norm: str = 'batchnorm2d',
                 final_activation=None, dropout: float = 0.1,
                 channels_mid: Optional[int] = None, stride: int = 1):
        super().__init__()
        mid = in_channels if channels_mid is None else channels_mid
        self.stride = stride
        self.padding = kernel_size // 2 if padding is None else padding
        self.block = nn.Sequential(
            nn.Conv2d(in_channels, mid, kernel_size, stride=stride, padding=self.padding),
            Norm(mid, norm),
            get_activation(activation),
            Dropout2d(dropout) if dropout else nn.Identity(),
            nn.Conv2d(mid, channels_out, 1))
        self.final_activation = None if final_activation is None else \
            get_activation(final_activation)

    def tail(self, mid: torch.Tensor) -> torch.Tensor:
        """Everything after conv0, applied to conv0's output."""
        y = self.block[1:](mid)
        return y if self.final_activation is None else self.final_activation(y)

    def forward(self, x):
        return self.tail(self.block[0](x))


class FusableReadOut(ReadOut):
    """A ``ReadOut`` whose conv0 sibling heads can fuse (:func:`fused_head_conv`).

    Same parameters as ``ReadOut``; a caller fuses the conv0s of heads that
    read the same map, then hands each head its channel slice via ``tail``.
    """

    @property
    def conv0(self) -> nn.Conv2d:
        return self.block[0]


def fused_head_conv(x: torch.Tensor, convs: Sequence[nn.Conv2d], stride: int,
                    padding: int) -> torch.Tensor:
    """One conv over the concatenated output channels of same-geometry convs.

    Every head keeps its own parameters; only the launch is shared: one pass
    over the input map instead of one per head, with the FLOPs unchanged.
    """
    weight = torch.cat([c.weight for c in convs], 0)
    bias = torch.cat([c.bias for c in convs], 0)
    return F.conv2d(x, weight, bias, stride=stride, padding=padding)
