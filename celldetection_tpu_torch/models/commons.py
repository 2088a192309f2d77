"""Building blocks (``nn.Module``s, NCHW inside).

Counterpart of ``celldetection_tpu/models/commons.py``: ``get_activation``
(105-114), ``Norm`` (117-150, every kind; batch norm in inference and
training), ``ConvNorm`` (203-221), ``ConvNormRelu`` (224-239),
``TwoConvNormRelu`` (242-262), ``ScaledTanh`` (269-275), ``ResBlock``
(287-310), ``ReadOut`` (348-384), ``fused_head_conv`` and ``FusableReadOut``
(406-474), ``Fuse`` (477-497), ``Normalize`` (503-522).

The U-Net family's submodules are ``nn.Sequential`` with the reference torch
layout, so the state-dict keys are the ones ``export_torch_state_dict``
emits (``TwoConvNormRelu``: conv 0, norm 1, conv 3, norm 4; ``ReadOut.block``:
conv0 0, norm 1, conv1 4; ``ResBlock`` the same, and its projection
``downsample.{0,1}``). The modules of the later families (``ConvNormRelu``,
``NamedNorm``) carry the JAX package's module names instead, so that their
keys are the flax paths joined by dots (``util.weights``).
"""
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.commons import interpolate_nchw

__all__ = ['get_activation', 'Norm', 'NamedNorm', 'ConvNorm', 'ConvNormRelu', 'TwoConvNormRelu',
           'ResBlock', 'ScaledTanh', 'Normalize', 'Dropout2d', 'StochasticDepth', 'ReadOut',
           'FusableReadOut', 'fused_head_conv', 'Fuse', 'same_padding']

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


def _norm_kind(kind) -> Optional[str]:
    """The JAX ``Norm``'s spelling rules: case and underscores ignored, 'nd' read as '2d'."""
    if kind is None:
        return None
    kind = str(kind).lower().replace('_', '').replace('nd', '2d')
    return None if kind in ('identity', 'none') else kind


class Norm(nn.Module):
    """The JAX ``Norm``: batch, layer, group or instance normalization of NCHW input.

    - ``'batchnorm2d'``: eps 1e-5 (``eps`` overrides it; MobileNetV3 takes
      1e-3). In eval mode it normalises with the running statistics. In
      train mode it normalises with the batch's mean and biased variance and
      updates the running statistics the way flax does: ``momentum`` (flax's
      convention, 0.9 by default) times the old value plus ``1 - momentum``
      times the batch's mean and *biased* variance, computed as flax
      computes it, ``E[x^2] - E[x]^2`` (``F.batch_norm`` would store the
      unbiased variance).
    - ``'layernorm2d'``: flax ``LayerNorm`` over the channels alone, eps 1e-5
      (not ``GroupNorm(1)``, which would reduce over space as well).
    - ``'groupnorm'``: flax ``GroupNorm`` with ``min(num_groups, C)`` groups,
      eps 1e-6 (flax's default, not torch's 1e-5); ``'instancenorm2d'``: the
      same with one group per channel.

    flax computes the layer and group variances as ``E[x^2] - E[x]^2``,
    torch with two passes; in float32 they part by a few ulp of the
    normalised values. Parameters ``weight``/``bias`` and the batch norm's
    buffers ``running_mean``/``running_var`` carry the reference names,
    without ``num_batches_tracked``, so the keys equal those of
    ``export_torch_state_dict``.
    """

    def __init__(self, num_features: int, kind: str = 'batchnorm2d', eps: Optional[float] = None,
                 momentum: float = BN_MOMENTUM, num_groups: int = 32):
        super().__init__()
        self.kind = _norm_kind(kind)
        if self.kind is None or not self.kind.startswith(
                ('batchnorm', 'layernorm', 'groupnorm', 'instancenorm')):
            raise ValueError(f'Unknown norm: {kind}')
        if self.kind.startswith('batchnorm'):
            self.eps = BN_EPS if eps is None else eps
        else:
            self.eps = (1e-5 if self.kind.startswith('layernorm') else 1e-6) if eps is None else eps
        self.momentum = momentum
        self.num_groups = num_features if self.kind.startswith('instancenorm') else \
            min(num_groups, num_features)
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        if self.kind.startswith('batchnorm'):
            self.register_buffer('running_mean', torch.zeros(num_features))
            self.register_buffer('running_var', torch.ones(num_features))

    def forward(self, x):
        if self.kind.startswith('layernorm'):
            y = F.layer_norm(x.movedim(1, -1), x.shape[1:2], self.weight, self.bias, self.eps)
            return y.movedim(-1, 1)
        if not self.kind.startswith('batchnorm'):
            return F.group_norm(x, self.num_groups, self.weight, self.bias, self.eps)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                training=False, eps=self.eps)
        with torch.no_grad():
            # flax's statistics: E[x^2] - E[x]^2, clipped at 0
            mean = x.mean((0, 2, 3))
            var = torch.clamp(x.square().mean((0, 2, 3)) - mean.square(), min=0.)
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        # the native kernels, not cuDNN's: on an H100 full-width CpnU22 trained
        # 6% faster with them, and its float32 gradients came out closer to
        # float64's (chip_smoke.py phase 11a)
        return torch.ops.aten.native_batch_norm(x, self.weight, self.bias, None, None, True, 0.,
                                                self.eps)[0]


class NamedNorm(nn.Module):
    """A :class:`Norm` as the JAX package's ``Norm(name=...)`` holds it: in a
    child named ``norm`` (keys ``<name>.norm.weight``, ...); identity for a
    kind of None."""

    def __init__(self, num_features: int, kind: Optional[str] = 'batchnorm2d', **kwargs):
        super().__init__()
        self.norm = None if _norm_kind(kind) is None else Norm(num_features, kind, **kwargs)

    def forward(self, x):
        return x if self.norm is None else self.norm(x)


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


class _NamedConvNorm(nn.Module):
    """The JAX ``ConvNorm``'s names: children ``conv`` and ``norm`` (a :class:`NamedNorm`)."""

    def __init__(self, in_channels, out_channels, kernel_size, padding, stride, norm_layer,
                 use_bias):
        super().__init__()
        pad = kernel_size // 2 if padding is None else padding
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride, padding=pad,
                              bias=use_bias)
        self.norm = NamedNorm(out_channels, norm_layer)

    def forward(self, x):
        return self.norm(self.conv(x))


class ConvNormRelu(nn.Module):
    """Convolution + normalization + activation under the JAX module names
    (``block.conv``, ``block.norm.norm``): Ppm's and MaNet's block."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 padding: Optional[int] = None, stride: int = 1,
                 norm_layer: Optional[str] = 'batchnorm2d', activation='relu',
                 use_bias: bool = True):
        super().__init__()
        self.block = _NamedConvNorm(in_channels, out_channels, kernel_size, padding, stride,
                                    norm_layer, use_bias)
        self.act = get_activation(activation)

    def forward(self, x):
        return self.act(self.block(x))


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


class ResBlock(TwoConvNormRelu):
    """Basic residual block: ``TwoConvNormRelu``'s layout without biases, the
    second activation after the sum, and a 1x1 ``downsample`` projection
    (conv 0, norm 1) when the channels or the stride change."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 padding: Optional[int] = None, norm_layer: str = 'batchnorm2d',
                 activation='relu', stride: int = 1):
        super().__init__(in_channels, out_channels, kernel_size, padding, stride,
                         norm_layer=norm_layer, activation=activation, use_bias=False)
        self.downsample = ConvNorm(in_channels, out_channels, 1, 0, stride, norm_layer,
                                   use_bias=False) \
            if in_channels != out_channels or stride != 1 else None

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self[2](self[1](self[0](x)))
        return self[5](self[4](self[3](out)) + identity)


def same_padding(x: torch.Tensor, kernel_size: int, stride: int) -> torch.Tensor:
    """Pad NCHW ``x`` as flax's ``Conv(padding='SAME')`` does for a kernel and
    stride: the output side is ``ceil(side / stride)``, and an odd total pad
    puts the extra row or column at the end."""
    pads = []
    for side in reversed(x.shape[2:]):
        total = max((-(-side // stride) - 1) * stride + kernel_size - side, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


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


class StochasticDepth(Dropout2d):
    """Drops a residual branch per sample (``(N, 1, 1, 1)`` masks) in train
    mode, as the JAX ``CNBlock`` does, scaled by ``1 / (1 - p)``; identity in
    eval mode. Its draws cannot equal flax's: they come from ``generator``,
    as :class:`Dropout2d`'s do."""

    def forward(self, x):
        if not self.training or not self.p:
            return x
        keep = 1. - self.p
        draw = torch.rand(x.shape[:1] + (1,) * (x.dim() - 1), generator=self.generator,
                          device=x.device)
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


class Fuse(nn.Module):
    """Feature fusion of NCHW maps: each resized (nearest) to the first
    map's size, concatenated, then conv, norm and activation in ``block``
    (conv 0, norm 1, the reference's ``Fuse2d`` layout)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 padding: int = 0, activation='relu', norm_layer: str = 'batchnorm2d'):
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, kernel_size, padding=padding),
            Norm(out_channels, norm_layer),
            get_activation(activation))

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        target = xs[0].shape[2:]
        xs = [x if x.shape[2:] == target else interpolate_nchw(x, target, 'nearest') for x in xs]
        return self.block(torch.cat(xs, 1))
