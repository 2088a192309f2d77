"""Building blocks (``nn.Module``s, NCHW inside).

Counterpart of ``celldetection_tpu/models/commons.py``: ``get_activation``
(105-114), ``Norm`` (117-150, every kind; batch norm in inference and
training), ``ConvNorm`` (203-221), ``ConvNormRelu`` (224-239),
``TwoConvNormRelu`` (242-262), ``ScaledTanh`` (269-275), ``ResBlock``
(287-310), ``ReadOut`` (348-384), ``fused_head_conv`` and ``FusableReadOut``
(406-474), ``Fuse`` (477-497), ``Normalize`` (503-522), and the rest of its
``__all__``: ``norm_overrides`` (54-71), ``kaiming_uniform`` (73-84),
``GroupedConv`` (153-200), ``TwoConvNormLeaky`` (265), ``ScaledSigmoid``
(278), ``BottleneckBlock`` (313-346), ``SqueezeExcitation`` (525),
``SelfAttention`` (546), ``LayerNorm2d`` (570), ``ReplayCache`` (579),
``MinibatchStdLayer`` (615), ``SpatialSplit`` (626), ``AdditiveNoise``
(636), ``Stride`` (656) and ``DynamicTanh`` (667). ``head_conv``, which
runs the heads' first convolution (on ``kernels/head_conv.py`` in bf16 on a
card), has no counterpart there: the JAX package leaves it to XLA.

The JAX blocks infer their spatial rank from the input; a torch module fixes
it when it is built, so every block with a convolution or a pool takes
``nd`` (2 or 3, the reference's name) and builds ``Conv3d`` and 3-D pools
for 3. ``Norm``, ``Dropout2d``, ``Stride`` and ``DynamicTanh`` have no
such layer and take input of any rank. ``SqueezeExcitation`` and
``SelfAttention`` stay 2-D, as in the JAX package.

The U-Net family's submodules are ``nn.Sequential`` with the reference torch
layout, so the state-dict keys are the ones ``export_torch_state_dict``
emits (``TwoConvNormRelu``: conv 0, norm 1, conv 3, norm 4; ``ReadOut.block``:
conv0 0, norm 1, conv1 4; ``ResBlock`` the same, and its projection
``downsample.{0,1}``). The modules of the later families (``ConvNormRelu``,
``NamedNorm``) carry the JAX package's module names instead, so that their
keys are the flax paths joined by dots (``util.weights``), and so do the
blocks this docstring names after ``Normalize``.
"""
import math
import threading
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..kernels.head_conv import head_conv_kernel, takes as head_conv_takes
from ..ops.commons import interpolate_nchw, minibatch_std_layer, split_spatially
from ..util.device import resolve_device
from ..util.spans import span

__all__ = ['get_activation', 'Norm', 'NamedNorm', 'ConvNorm', 'ConvNormRelu', 'TwoConvNormRelu',
           'TwoConvNormLeaky', 'ResBlock', 'BottleneckBlock', 'ScaledTanh', 'ScaledSigmoid',
           'Normalize', 'Dropout2d', 'StochasticDepth', 'ReadOut', 'FusableReadOut',
           'head_conv', 'fused_head_conv', 'Fuse', 'same_padding', 'set_norm_group_',
           'norm_overrides', 'kaiming_uniform', 'GroupedConv', 'SqueezeExcitation',
           'SelfAttention', 'LayerNorm2d', 'ReplayCache', 'MinibatchStdLayer', 'SpatialSplit',
           'AdditiveNoise', 'Stride', 'DynamicTanh']

BN_EPS = 1e-5
BN_MOMENTUM = 0.9    # flax's convention: running = momentum * running + (1 - momentum) * batch

_CONV = {2: nn.Conv2d, 3: nn.Conv3d}
_MAX_POOL = {2: nn.MaxPool2d, 3: nn.MaxPool3d}


def conv_nd(nd: int):
    """The convolution class of spatial rank ``nd`` (2 or 3)."""
    if nd not in _CONV:
        raise ValueError(f'nd={nd}: convolutions of rank 2 or 3')
    return _CONV[nd]


def max_pool_nd(nd: int):
    """The max-pool class of spatial rank ``nd`` (2 or 3)."""
    if nd not in _MAX_POOL:
        raise ValueError(f'nd={nd}: pools of rank 2 or 3')
    return _MAX_POOL[nd]


# Overrides of the batch norms' momentum and epsilon for the calls made
# inside a ``norm_overrides`` block, per thread, so that concurrent calls of
# differently tweaked models do not see each other's (the JAX package's
# ``_NORM_TLS``).
_NORM_TLS = threading.local()


def _current_norm_overrides() -> dict:
    return getattr(_NORM_TLS, 'overrides', {})


class norm_overrides:
    """Context manager: inside it every batch :class:`Norm` of this thread
    takes ``overrides['batchnorm']``'s ``momentum`` and ``epsilon`` in place
    of its own, in flax's convention (``momentum`` weighs the old running
    value; torch's momentum ``t`` is ``1 - t`` here, as ``conf2tweaks_``
    converts it), e.g. ``norm_overrides({'batchnorm': {'momentum': 0.95}})``.
    Blocks nest; the inner one's keys win."""

    def __init__(self, overrides: Optional[dict]):
        self.overrides = overrides or {}

    def __enter__(self):
        self._saved = _current_norm_overrides()
        _NORM_TLS.overrides = {**self._saved, **self.overrides}
        return self

    def __exit__(self, *exc):
        _NORM_TLS.overrides = self._saved
        return False


def kaiming_uniform(a: float = 1.0):
    """He (kaiming) uniform init with negative slope ``a``: returns
    ``init(tensor, generator=None)``, which fills ``tensor`` in place with
    ``U(+-sqrt(6 / ((1 + a^2) fan_in)))`` and returns it. The fan-in is the
    product of every dim but the output (a torch kernel's dims after the
    first, as the JAX package's are those before the last)."""
    def init(tensor: torch.Tensor, generator: Optional[torch.Generator] = None):
        fan_in = math.prod(tensor.shape[1:])
        bound = math.sqrt(2.0 / (1 + a ** 2)) * math.sqrt(3.0 / fan_in)
        with torch.no_grad():
            return tensor.uniform_(-bound, bound, generator=generator)
    return init


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

    Input of any spatial rank (NC..., 2-D or 3-D). Inside a
    :class:`norm_overrides` block a batch norm takes its momentum and epsilon.

    flax computes the layer and group variances as ``E[x^2] - E[x]^2``,
    torch with two passes; in float32 they part by a few ulp of the
    normalised values. Parameters ``weight``/``bias`` and the batch norm's
    buffers ``running_mean``/``running_var`` carry the reference names,
    without ``num_batches_tracked``, so the keys equal those of
    ``export_torch_state_dict``.

    With a process group in ``group`` (:func:`set_norm_group_`), a batch
    norm in train mode takes the statistics of the global batch, the union
    of every rank's, as the JAX package's norm does under a data-parallel
    ``jit`` (:class:`_GlobalBatchNorm`).
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
        self.group = None
        if self.kind.startswith('batchnorm'):
            self.register_buffer('running_mean', torch.zeros(num_features))
            self.register_buffer('running_var', torch.ones(num_features))

    def forward(self, x):
        if self.kind.startswith('layernorm'):
            y = F.layer_norm(x.movedim(1, -1), x.shape[1:2], self.weight, self.bias, self.eps)
            return y.movedim(-1, 1)
        if not self.kind.startswith('batchnorm'):
            return F.group_norm(x, self.num_groups, self.weight, self.bias, self.eps)
        ov = _current_norm_overrides().get('batchnorm', {})
        eps = ov.get('epsilon', self.eps)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                training=False, eps=eps)
        m = ov.get('momentum', self.momentum)
        if self.group is not None:
            return _GlobalBatchNorm.apply(x, self.weight, self.bias, self.running_mean,
                                          self.running_var, eps, m, self.group)
        with torch.no_grad():
            # flax's statistics: E[x^2] - E[x]^2, clipped at 0
            dims = (0,) + tuple(range(2, x.dim()))
            mean = x.mean(dims)
            var = torch.clamp(x.square().mean(dims) - mean.square(), min=0.)
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        # the native kernels, not cuDNN's: on an H100 full-width CpnU22 trained
        # 6% faster with them, and its float32 gradients came out closer to
        # float64's (chip_smoke.py phase 11a)
        return torch.ops.aten.native_batch_norm(x, self.weight, self.bias, None, None, True, 0.,
                                                eps)[0]


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch norm over the union of every rank's batch.

    Forward: one all-reduce of the per-channel sums of ``x`` and ``x^2`` and
    the element count gives flax's statistics of the global batch, ``E[x]``
    and ``E[x^2] - E[x]^2`` clipped at 0; the native kernel normalises with
    them and the running statistics move by ``momentum`` as flax's do.
    Backward: one all-reduce of the per-channel sums of ``dy`` and
    ``dy * (x - mean)`` gives the input gradient of the global batch; the
    weight and bias gradients stay this rank's (DistributedDataParallel
    averages them with the rest). On a card the backward runs the native
    kernels of ``nn.SyncBatchNorm``, which has none for the CPU, where the
    same sums are plain reductions.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps, momentum, group):
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        count = torch.full((1,), x.numel() // c, dtype=x.dtype, device=x.device)
        stats = torch.cat([x.sum(dims), x.square().sum(dims), count])
        dist.all_reduce(stats, group=group)
        n = stats[2 * c]
        mean = stats[:c] / n
        var = torch.clamp(stats[c:2 * c] / n - mean.square(), min=0.)
        running_mean.copy_(momentum * running_mean + (1 - momentum) * mean)
        running_var.copy_(momentum * running_var + (1 - momentum) * var)
        invstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.group, ctx.count = group, n
        return torch.ops.aten.native_batch_norm(x, weight, bias, mean, var, False, 0., eps)[0]

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd = ctx.saved_tensors
        dy = dy.contiguous()
        c = x.shape[1]
        if x.device.type == 'cuda':
            sum_dy, sum_dy_xmu, grad_w, grad_b = torch.batch_norm_backward_reduce(
                dy, x, mean, invstd, weight, True, True, True)
            sums = torch.cat([sum_dy, sum_dy_xmu])
            dist.all_reduce(sums, group=ctx.group)
            dx = torch.batch_norm_backward_elemt(dy, x, mean, invstd, weight, sums[:c], sums[c:],
                                                 ctx.count.to(torch.int32).reshape(1))
            return dx, grad_w, grad_b, None, None, None, None, None
        dims = [0] + list(range(2, x.dim()))
        shape = (1, c) + (1,) * (x.dim() - 2)
        xmu = x - mean.reshape(shape)
        local = torch.cat([dy.sum(dims), (dy * xmu).sum(dims)])
        grad_w, grad_b = local[c:] * invstd, local[:c].clone()
        dist.all_reduce(local, group=ctx.group)
        mean_dy, mean_dy_xmu = local[:c] / ctx.count, local[c:] / ctx.count
        inv = invstd.reshape(shape)
        dx = (dy - mean_dy.reshape(shape) - xmu * inv.square() * mean_dy_xmu.reshape(shape)) \
            * inv * weight.reshape(shape)
        return dx, grad_w, grad_b, None, None, None, None, None


def set_norm_group_(model: nn.Module, group) -> nn.Module:
    """Give every :class:`Norm` of ``model`` the process group whose global
    batch its train-mode statistics cover (None: this rank's batch alone)."""
    for m in model.modules():
        if isinstance(m, Norm):
            m.group = group
    return model


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
                 groups: int = 1, nd: int = 2):
        pad = kernel_size // 2 if padding is None else padding
        layers = [conv_nd(nd)(in_channels, out_channels, kernel_size, stride=stride, padding=pad,
                              bias=use_bias, groups=groups)]
        if norm_layer is not None:
            layers.append(Norm(out_channels, norm_layer))
        super().__init__(*layers)


class _NamedConvNorm(nn.Module):
    """The JAX ``ConvNorm``'s names: children ``conv`` and ``norm`` (a :class:`NamedNorm`)."""

    def __init__(self, in_channels, out_channels, kernel_size, padding, stride, norm_layer,
                 use_bias, groups=1, nd=2):
        super().__init__()
        pad = kernel_size // 2 if padding is None else padding
        self.conv = conv_nd(nd)(in_channels, out_channels, kernel_size, stride=stride,
                                padding=pad, bias=use_bias, groups=groups)
        self.norm = NamedNorm(out_channels, norm_layer)

    def forward(self, x):
        return self.norm(self.conv(x))


class ConvNormRelu(nn.Module):
    """Convolution + normalization + activation under the JAX module names
    (``block.conv``, ``block.norm.norm``): Ppm's and MaNet's block."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 padding: Optional[int] = None, stride: int = 1,
                 norm_layer: Optional[str] = 'batchnorm2d', activation='relu',
                 use_bias: bool = True, nd: int = 2):
        super().__init__()
        self.block = _NamedConvNorm(in_channels, out_channels, kernel_size, padding, stride,
                                    norm_layer, use_bias, nd=nd)
        self.act = get_activation(activation)

    def forward(self, x):
        return self.act(self.block(x))


class TwoConvNormRelu(nn.Sequential):
    """conv-norm-act x2 (the U-Net block), flat: conv 0, norm 1, act 2, conv 3, norm 4, act 5."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 padding: Optional[int] = None, stride: int = 1,
                 mid_channels: Optional[int] = None, norm_layer: str = 'batchnorm2d',
                 activation='relu', use_bias: bool = True, nd: int = 2):
        mid = out_channels if mid_channels is None else mid_channels
        super().__init__(
            *ConvNorm(in_channels, mid, kernel_size, padding, stride, norm_layer, use_bias,
                      nd=nd),
            get_activation(activation),
            *ConvNorm(mid, out_channels, kernel_size, padding, 1, norm_layer, use_bias, nd=nd),
            get_activation(activation))


class TwoConvNormLeaky(TwoConvNormRelu):
    """:class:`TwoConvNormRelu` with leaky ReLUs (negative slope 0.01)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 padding: Optional[int] = None, stride: int = 1,
                 mid_channels: Optional[int] = None, norm_layer: str = 'batchnorm2d',
                 activation='leakyrelu', use_bias: bool = True, nd: int = 2):
        super().__init__(in_channels, out_channels, kernel_size, padding, stride, mid_channels,
                         norm_layer, activation, use_bias, nd)


class ResBlock(TwoConvNormRelu):
    """Basic residual block: ``TwoConvNormRelu``'s layout without biases, the
    second activation after the sum, and a 1x1 ``downsample`` projection
    (conv 0, norm 1) when the channels or the stride change."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 padding: Optional[int] = None, norm_layer: str = 'batchnorm2d',
                 activation='relu', stride: int = 1, nd: int = 2):
        super().__init__(in_channels, out_channels, kernel_size, padding, stride,
                         norm_layer=norm_layer, activation=activation, use_bias=False, nd=nd)
        self.downsample = ConvNorm(in_channels, out_channels, 1, 0, stride, norm_layer,
                                   use_bias=False, nd=nd) \
            if in_channels != out_channels or stride != 1 else None

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self[2](self[1](self[0](x)))
        return self[5](self[4](self[3](out)) + identity)


class BottleneckBlock(nn.Module):
    """1x1, kxk (``groups``), 1x1 bottleneck residual block under the JAX
    names: ``block0``, ``block1``, ``block2`` and the 1x1 projection
    ``downsample`` (when the channels or the stride change), each a
    convolution ``conv`` without bias and a norm ``norm.norm``. The middle
    width is ``mid_channels`` or ``max(base_channels, out // compression,
    in // compression)``. A ``block_cls`` of the U-Net encoder and decoder."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 padding: Optional[int] = None, mid_channels: Optional[int] = None,
                 compression: int = 4, base_channels: int = 64,
                 norm_layer: Optional[str] = 'batchnorm2d', activation='relu', stride: int = 1,
                 groups: int = 1, nd: int = 2):
        super().__init__()
        mid = mid_channels or max(base_channels, out_channels // compression,
                                  in_channels // compression)
        self.block0 = _NamedConvNorm(in_channels, mid, 1, 0, 1, norm_layer, False, nd=nd)
        self.block1 = _NamedConvNorm(mid, mid, kernel_size, padding, stride, norm_layer, False,
                                     groups=groups, nd=nd)
        self.block2 = _NamedConvNorm(mid, out_channels, 1, 0, 1, norm_layer, False, nd=nd)
        self.downsample = _NamedConvNorm(in_channels, out_channels, 1, 0, stride, norm_layer,
                                         False, nd=nd) \
            if in_channels != out_channels or stride != 1 else None
        self.act = get_activation(activation)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.act(self.block0(x))
        out = self.act(self.block1(out))
        return self.act(self.block2(out) + identity)


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


class ScaledSigmoid(ScaledTanh):
    """``sigmoid(x) * factor + shift``."""

    def forward(self, x):
        return torch.sigmoid(x) * self.factor + self.shift


class Normalize(nn.Module):
    """``(clamp(x, *assert_range) - mean) / std`` over NC... input (2-D or 3-D).

    The JAX package clamps where the reference asserts; so does this port.
    ``mean``/``std`` are scalars or per-channel sequences. Their tensors are
    made once per dtype and device and kept (not in the state dict): copied
    from the host on each call, they would make the host wait for the card.
    """

    def __init__(self, mean=0., std=1., assert_range=(0., 1.)):
        super().__init__()
        self.mean = mean
        self.std = std
        self.assert_range = assert_range
        self._tensors = {}

    def _mean_std(self, dtype, device):
        key = (dtype, device)
        made = self._tensors.get(key)
        if made is None or made[0] is not self.mean or made[1] is not self.std:
            kw = dict(dtype=dtype, device=device)
            made = self._tensors[key] = (self.mean, self.std, torch.as_tensor(self.mean, **kw),
                                         torch.as_tensor(self.std, **kw))
        return made[2:]

    def forward(self, x):
        if self.assert_range is not None:
            x = x.clamp(*self.assert_range)
        mean, std = self._mean_std(x.dtype, x.device)
        channel = (-1,) + (1,) * (x.dim() - 2)
        if mean.dim():
            mean = mean.reshape(channel)
        if std.dim():
            std = std.reshape(channel)
        return (x - mean) / std


class Dropout2d(nn.Module):
    """Whole-channel dropout of NC... input (2-D or 3-D) in train mode, identity in eval mode.

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
        draw = torch.rand(x.shape[:2] + (1,) * (x.dim() - 2), generator=self.generator,
                          device=x.device)
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
                 channels_mid: Optional[int] = None, stride: int = 1, nd: int = 2):
        super().__init__()
        mid = in_channels if channels_mid is None else channels_mid
        self.stride = stride
        self.padding = kernel_size // 2 if padding is None else padding
        conv = conv_nd(nd)
        self.block = nn.Sequential(
            conv(in_channels, mid, kernel_size, stride=stride, padding=self.padding),
            Norm(mid, norm),
            get_activation(activation),
            Dropout2d(dropout) if dropout else nn.Identity(),
            conv(mid, channels_out, 1))
        self.final_activation = None if final_activation is None else \
            get_activation(final_activation)

    def tail(self, mid: torch.Tensor) -> torch.Tensor:
        """Everything after conv0, applied to conv0's output."""
        y = self.block[1:](mid)
        return y if self.final_activation is None else self.final_activation(y)

    def forward(self, x):
        conv0 = self.block[0]
        return self.tail(head_conv(x, conv0.weight, conv0.bias, self.stride, self.padding))


class FusableReadOut(ReadOut):
    """A ``ReadOut`` whose conv0 sibling heads can fuse (:func:`fused_head_conv`).

    Same parameters as ``ReadOut``; a caller fuses the conv0s of heads that
    read the same map, then hands each head its channel slice via ``tail``.
    """

    @property
    def conv0(self) -> nn.Module:
        return self.block[0]


def head_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], stride,
              padding) -> torch.Tensor:
    """A CPN head's first K x K convolution (2-D or 3-D, the rank of ``x``).

    It takes the hand-written kernel (:func:`..kernels.head_conv.head_conv_kernel`)
    where :func:`..kernels.head_conv.takes` holds: on a CUDA card, with no
    gradient to keep, bf16, 2-D, stride 1, "same" padding of an odd K,
    channels multiples of 64. Everything else (fp32 and TF32, the CPU, 3-D
    heads, training, other strides) runs ``F.conv2d``/``F.conv3d`` as the
    module would. The span ``cpn.head_conv`` counts ``kernel`` (1 or 0) and
    ``cout``, and the kernel's ``launches``.
    """
    kernel = head_conv_takes(x, weight, bias, stride, padding)
    with span('cpn.head_conv', kernel=int(kernel), cout=weight.shape[0]):
        if kernel:
            return head_conv_kernel(x, weight, bias)
        conv = F.conv2d if x.dim() == 4 else F.conv3d
        return conv(x, weight, bias, stride=stride, padding=padding)


def fused_head_conv(x: torch.Tensor, convs: Sequence[nn.Module], stride: int,
                    padding: int) -> torch.Tensor:
    """One conv over the concatenated output channels of same-geometry convs
    (2-D or 3-D, the rank of ``x``), through :func:`head_conv`.

    Every head keeps its own parameters; only the launch is shared: one pass
    over the input map instead of one per head, with the FLOPs unchanged.
    """
    weight = torch.cat([c.weight for c in convs], 0)
    bias = torch.cat([c.bias for c in convs], 0)
    return head_conv(x, weight, bias, stride, padding)


class Fuse(nn.Module):
    """Feature fusion of NC... maps: each resized (nearest) to the first
    map's size, concatenated, then conv, norm and activation in ``block``
    (conv 0, norm 1, the reference's ``Fuse2d`` layout). ``in_channels`` is
    the sum of the maps' channels."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 padding: int = 0, activation='relu', norm_layer: str = 'batchnorm2d',
                 nd: int = 2):
        super().__init__()
        self.block = nn.Sequential(
            conv_nd(nd)(in_channels, out_channels, kernel_size, padding=padding),
            Norm(out_channels, norm_layer),
            get_activation(activation))

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        target = xs[0].shape[2:]
        xs = [x if x.shape[2:] == target else interpolate_nchw(x, target, 'nearest') for x in xs]
        return self.block(torch.cat(xs, 1))


def GroupedConv(in_channels: int, features: int, kernel_size, groups: int, strides=None,
                padding=0) -> nn.Module:
    """The JAX ``GroupedConv``: a bias-free convolution with ``groups``, of the
    rank of ``kernel_size`` (an int is 2-D). Its ``weight`` is the JAX
    ``kernel`` ``(*k, in / groups, features)`` as ``(features, in / groups,
    *k)``; the block-diagonal dense form the JAX package takes on a TPU is
    the same function. ``padding``: an int, one int per dim, or symmetric
    ``(lo, hi)`` pairs."""
    k = (kernel_size,) * 2 if isinstance(kernel_size, int) else tuple(kernel_size)
    nd = len(k)
    pad = [padding] * nd if isinstance(padding, int) else list(padding)
    if any(not isinstance(p, int) and p[0] != p[1] for p in pad):
        raise ValueError(f'GroupedConv: asymmetric padding {padding} is not ported')
    pad = tuple(p if isinstance(p, int) else p[0] for p in pad)
    return conv_nd(nd)(in_channels, features, k, stride=tuple(strides or (1,) * nd),
                       padding=pad, groups=groups, bias=False)


class SqueezeExcitation(nn.Module):
    """Squeeze-and-excitation of NCHW input, with the residual add by default:
    the spatial mean through ``fc0`` (``squeeze_channels`` or ``max(C //
    compression, 1)``), ``activation``, ``fc1`` and ``scale_activation``
    scales the input."""

    def __init__(self, in_channels: int, squeeze_channels: Optional[int] = None,
                 compression: int = 16, activation='relu', scale_activation='sigmoid',
                 residual: bool = True):
        super().__init__()
        sq = squeeze_channels or max(in_channels // compression, 1)
        self.fc0 = nn.Conv2d(in_channels, sq, 1)
        self.act = get_activation(activation)
        self.fc1 = nn.Conv2d(sq, in_channels, 1)
        self.scale_act = get_activation(scale_activation)
        self.residual = residual

    def forward(self, x):
        scale = self.scale_act(self.fc1(self.act(self.fc0(x.mean((2, 3), keepdim=True)))))
        scaled = x * scale
        return x + scaled if self.residual else scaled


class SelfAttention(nn.Module):
    """SAGAN-style self-attention over the flattened positions of NCHW input.

    ``in_conv`` (3x3, when the channels change), the affinities ``p[i, j] =
    proj_a(x)_i . proj_b(x)_j`` softmaxed over ``i``, ``out_j = sum_i p[i, j]
    proj(x)_i``, then ``out_conv(beta * out + x)`` (``beta`` a parameter
    starting at 0, or 1). The two products are batched matmuls over the
    ``hw x hw`` map.
    """

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 mid_channels: Optional[int] = None, beta: bool = True):
        super().__init__()
        c_out = out_channels or in_channels
        c_mid = mid_channels or in_channels // 8
        self.in_conv = nn.Conv2d(in_channels, c_out, 3, padding=1) \
            if in_channels != c_out else None
        self.proj_a = nn.Conv2d(c_out, c_mid, 1)
        self.proj_b = nn.Conv2d(c_out, c_mid, 1)
        self.proj = nn.Conv2d(c_out, c_out, 1)
        self.out_conv = nn.Conv2d(c_out, c_out, 1)
        self.beta = nn.Parameter(torch.zeros(1)) if beta else None

    def forward(self, x):
        if self.in_conv is not None:
            x = self.in_conv(x)
        a = self.proj_a(x).flatten(2)                                   # [n, mid, i]
        b = self.proj_b(x).flatten(2)                                   # [n, mid, j]
        p = torch.softmax(torch.matmul(a.transpose(1, 2), b), 1)        # [n, i, j], over i
        out = torch.matmul(self.proj(x).flatten(2), p).reshape(x.shape)  # [n, c, j]
        if self.beta is not None:
            out = self.beta * out
        return self.out_conv(out + x)


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of NCHW input (``ln``, eps 1e-5)."""

    def __init__(self, channels: int, epsilon: float = 1e-5):
        super().__init__()
        self.ln = nn.LayerNorm(channels, eps=epsilon)

    def forward(self, x):
        return self.ln(x.movedim(1, -1)).movedim(-1, 1)


class ReplayCache:
    """Experience-replay cache for GAN training, a host container.

    :meth:`add` stores a random ``fraction`` of a batch's items (numpy
    copies) and drops random items while it holds more than ``size``;
    calling the cache draws ``num`` items with replacement and returns them
    stacked as a tensor on ``device`` (``cuda`` unless the caller names
    another). Draws come from ``rng``, a ``numpy.random.RandomState``.
    """

    def __init__(self, size: int = 128, rng: Optional[np.random.RandomState] = None):
        self.cache = []
        self.size = size
        self.rng = np.random.RandomState() if rng is None else rng

    def __len__(self):
        return len(self.cache)

    def is_empty(self):
        return len(self) <= 0

    def add(self, x, fraction: float = .5):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        x = np.asarray(x)
        n = len(x)
        for i in self.rng.choice(np.arange(n), int(n * fraction), replace=False):
            self.cache.append(np.array(x[i]))
        while len(self) > self.size:
            del self.cache[self.rng.randint(0, len(self))]

    def __call__(self, num: int, device=None) -> Optional[torch.Tensor]:
        if self.is_empty():
            return None
        device = resolve_device(device)
        idx = self.rng.randint(0, len(self), num)
        return torch.from_numpy(np.stack([self.cache[i] for i in idx], 0)).to(device)


class MinibatchStdLayer(nn.Module):
    """Appends ``channels`` minibatch standard-deviation maps to NCHW input
    (:func:`..ops.commons.minibatch_std_layer`)."""

    def __init__(self, channels: int = 1, group_channels: Optional[int] = None,
                 epsilon: float = 1e-8):
        super().__init__()
        self.channels, self.group_channels, self.epsilon = channels, group_channels, epsilon

    def forward(self, x):
        y = minibatch_std_layer(x.permute(0, 2, 3, 1), self.channels, self.group_channels,
                                self.epsilon)
        return y.permute(0, 3, 1, 2)


class SpatialSplit(nn.Module):
    """Folds ``height x width`` patches of NCHW input into the batch, row-major
    per image (:func:`..ops.commons.split_spatially`)."""

    def __init__(self, height: int, width: Optional[int] = None):
        super().__init__()
        self.size = (height, width or height)

    def forward(self, x):
        return split_spatially(x.permute(0, 2, 3, 1), self.size).permute(0, 3, 1, 2)


class AdditiveNoise(nn.Module):
    """Adds Gaussian noise (``mean``, ``std``) in train mode, weighted per
    channel by ``weight`` (a parameter starting at 0) when ``weighted``;
    identity in eval mode. Each of the ``noise_channels`` noise maps covers
    ``C // noise_channels`` adjacent channels. The draws come from
    ``generator`` (torch's default when None), on the input's device."""

    def __init__(self, channels: int, noise_channels: int = 1, mean: float = 0., std: float = 1.,
                 weighted: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.noise_channels, self.mean, self.std = noise_channels, mean, std
        self.weight = nn.Parameter(torch.zeros(channels)) if weighted else None
        self.generator = generator

    def noise(self, x: torch.Tensor) -> torch.Tensor:
        """Standard normal draws ``[N, noise_channels, *spatial]`` for ``x``."""
        shape = (x.shape[0], self.noise_channels) + tuple(x.shape[2:])
        return torch.randn(shape, generator=self.generator, device=x.device, dtype=x.dtype)

    def forward(self, x):
        if not self.training:
            return x
        noise = self.noise(x) * self.std + self.mean
        noise = torch.repeat_interleave(noise, x.shape[1] // self.noise_channels, 1)
        if self.weight is None:
            return x + noise
        return x + noise * self.weight.reshape((-1,) + (1,) * (x.dim() - 2))


class Stride(nn.Module):
    """Every ``stride``-th position from ``start`` along each spatial dim of NC... input."""

    def __init__(self, stride: int, start: int = 0):
        super().__init__()
        self.stride, self.start = stride, start

    def forward(self, x):
        return x[(slice(None),) * 2 + (slice(self.start, None, self.stride),) * (x.dim() - 2)]


class DynamicTanh(nn.Module):
    """DyT (arXiv 2503.10622), a normalisation's replacement:
    ``tanh(alpha * x) * weight + bias`` per channel of NC... input."""

    def __init__(self, channels: int, alpha_init_value: float = 0.5):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), float(alpha_init_value)))
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        channel = (-1,) + (1,) * (x.dim() - 2)
        return torch.tanh(self.alpha * x) * self.weight.reshape(channel) + \
            self.bias.reshape(channel)
