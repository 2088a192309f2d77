"""Plain reference of ``cpn_resnet50_unet_mamba``: CpnResNet50UNet of
celldetection v0.4.9 with ``backbone_kwargs={'secondary_block': MambaLayer}``
(``celldetection/models/mamba.py:14-55``; ``models/resnet.py:196``), the
Mamba block of Gu & Dao 2023 (arXiv:2312.00752) with ``mamba_ssm``'s
defaults.

The encoder, decoder and heads are the flagship's
(:mod:`.cpn_resnext101_unet`) at ResNet50's sizes: (3, 4, 6, 3) bottlenecks,
one group of width 64. After each of the four stages' layers a Mamba layer
mixes the stage's pixels as one sequence (row-major positions) before the
stage feeds the next one and the decoder:

    seq = flatten(x)                                   [n, L, C]
    out = seq + Mamba(LayerNorm(seq))

and Mamba, with ``d_inner = expand C``, Δ's rank ``R`` (``'auto'``:
``ceil(C / 16)``) and ``N = d_state``:

    x, z = split(in_proj(h))                           no bias
    x = silu(conv1d(x))                                depthwise, causal: left pad d_conv - 1, bias
    δ, B, C = split(x_proj(x), [R, N, N])              no bias
    Δ = softplus(dt_proj(δ))                           bias
    A = -exp(A_log)
    s_t = exp(Δ_t A) s_{t-1} + Δ_t B_t x_t,  y_t = C_t · s_t + D x_t
    out = out_proj(y * silu(z))                        no bias

The matmuls, the convolution, the norm and the scan run in the precision's
type, so the bf16 control is a real control of the scan too; the scan, in
float32 for the comparison that decides ``correct``, runs sequentially over
chunks of :data:`SCAN_CHUNK` tokens, each chunk exact by its pairwise decays
``exp(S_t - S_s)`` (``s <= t``, ``S`` the chunk's cumulative sum of ``Δ A``):
independent of the program's log-depth order, and a check batch takes
seconds. Its arithmetic is elementwise, so :mod:`..flops` counts the
Mamba's projections and convolution, not the scan.

Departures from the source, and points not checked against it (its code is
not in this repository):

- the norm's epsilon is 1e-6 (flax's, as the JAX package and the program),
  where ``torch.nn.LayerNorm``'s default is 1e-5 (unchecked);
- the layer adds its input back, a residual (unchecked);
- one layer after each stage's layer, where the source may put it inside
  the layer, after each block: 16 layers, not 4 (unchecked;
  ``models/resnet.py:143-144`` of the program says the reference puts it
  inside; the configuration lists ``mamba_layers_per_stage`` in ``reduced``);
- ``mamba_ssm``'s fused kernels (``selective_scan_fn`` with ``delta_bias``
  and ``delta_softplus``, ``causal_conv1d``) are written out as the same
  equations in plain torch.

:func:`init_weights` gives the leaves that ``mamba_ssm`` initialises their
published values; the rest keep the benchmark's default draw.
"""
import math

import torch
import torch.nn.functional as F

from . import cpn
from .cpn_resnext101_unet import _bottleneck, _layer_keys, encoder_channels
from .cpn_resnext101_unet import shapes as encoder_decoder_shapes

LN_EPS = 1e-6
SCAN_CHUNK = 32
DT_MIN, DT_MAX, DT_FLOOR = 1e-3, 1e-1, 1e-4      # mamba_ssm's dt_min, dt_max, dt_init_floor
PREFIX = 'core.backbone.body.secondary'


def mamba_sizes(cfg: dict, channels: int):
    """``(d_inner, d_state, d_conv, dt_rank)`` of the Mamba layer on ``channels``."""
    m = cfg['backbone_kwargs']['secondary_block']
    rank = math.ceil(channels / 16) if m['dt_rank'] == 'auto' else int(m['dt_rank'])
    return m['expand'] * channels, m['d_state'], m['d_conv'], rank


def shapes(cfg: dict) -> dict:
    out = encoder_decoder_shapes(cfg)
    for i, c in enumerate(encoder_channels(cfg)[1:]):
        key = f'{PREFIX}{i + 1}'
        d_inner, n, d_conv, rank = mamba_sizes(cfg, c)
        out[f'{key}.norm.weight'] = (c,)
        out[f'{key}.norm.bias'] = (c,)
        out[f'{key}.mamba.in_proj.weight'] = (2 * d_inner, c)
        out[f'{key}.mamba.conv1d.weight'] = (d_inner, 1, d_conv)
        out[f'{key}.mamba.conv1d.bias'] = (d_inner,)
        out[f'{key}.mamba.x_proj.weight'] = (rank + 2 * n, d_inner)
        out[f'{key}.mamba.dt_proj.weight'] = (d_inner, rank)
        out[f'{key}.mamba.dt_proj.bias'] = (d_inner,)
        out[f'{key}.mamba.A_log'] = (d_inner, n)
        out[f'{key}.mamba.D'] = (d_inner,)
        out[f'{key}.mamba.out_proj.weight'] = (c, d_inner)
    return out


def init_weights(p: dict, cfg: dict, gen: torch.Generator):
    """``mamba_ssm``'s initial values, in place: ``A_log = log(1..N)`` on every
    channel, ``D = 1``, ``dt_proj.weight ~ U(-R^-1/2, R^-1/2)``, ``dt_proj.bias``
    the softplus inverse of ``dt = exp(U(log 1e-3, log 1e-1))`` clamped at 1e-4."""
    for i, c in enumerate(encoder_channels(cfg)[1:]):
        key = f'{PREFIX}{i + 1}.mamba'
        d_inner, n, _, rank = mamba_sizes(cfg, c)
        dev = p[f'{key}.D'].device
        p[f'{key}.A_log'] = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=dev)
                                      ).expand(d_inner, n).contiguous()
        p[f'{key}.D'] = torch.ones(d_inner, device=dev)
        u = torch.rand(d_inner, rank, generator=gen, device=dev)
        p[f'{key}.dt_proj.weight'] = (u * 2 - 1) * rank ** -0.5
        u = torch.rand(d_inner, generator=gen, device=dev)
        dt = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN)) + math.log(DT_MIN))
        dt = dt.clamp(min=DT_FLOOR)
        p[f'{key}.dt_proj.bias'] = dt + torch.log(-torch.expm1(-dt))


def scan(u, delta, A, B, C, D, chunk: int = SCAN_CHUNK):
    """``y_t = C_t · s_t + D u_t`` with ``s_t = exp(Δ_t A) s_{t-1} + Δ_t B_t u_t``
    from ``s = 0``: ``u``, ``delta`` ``[b, L, d]``, ``A`` ``[d, N]``, ``B``, ``C``
    ``[b, L, N]``, ``D`` ``[d]``, all of the scan's type. Chunk after chunk; inside
    a chunk ``s_t = exp(S_t) s_0 + sum_{s <= t} exp(S_t - S_s) Δ_s B_s u_s``."""
    b, length, d = u.shape
    state = u.new_zeros(b, d, A.shape[1])
    ys = []
    for s in range(0, length, chunk):
        dt = delta[:, s:s + chunk]                                   # [b, T, d]
        t = dt.shape[1]
        S = (dt[..., None] * A).cumsum(1)                            # [b, T, d, N]
        inp = dt[..., None] * B[:, s:s + chunk, None, :] * u[:, s:s + chunk, :, None]
        later = torch.ones(t, t, dtype=torch.bool, device=u.device).triu(1)   # s > t
        diff = (S[:, :, None] - S[:, None]).masked_fill(later[:, :, None, None], -math.inf)
        states = (torch.exp(diff) * inp[:, None]).sum(2) + torch.exp(S) * state[:, None]
        ys.append((states * C[:, s:s + chunk, None, :]).sum(-1))
        state = states[:, -1]
    return torch.cat(ys, 1) + u * D


def mamba(h, p: dict, key: str, cfg: dict, prec):
    """The Mamba block ``key`` over ``[n, L, C]`` ``h`` (see the module's docstring)."""
    d_inner, n, d_conv, rank = mamba_sizes(cfg, h.shape[-1])
    dt = prec.dtype
    x, z = F.linear(h, p[f'{key}.in_proj.weight'].to(dt)).chunk(2, -1)
    x = F.conv1d(F.pad(x.transpose(1, 2), (d_conv - 1, 0)), p[f'{key}.conv1d.weight'].to(dt),
                 p[f'{key}.conv1d.bias'].to(dt), groups=d_inner)
    x = F.silu(x.transpose(1, 2))
    low, Bm, Cm = F.linear(x, p[f'{key}.x_proj.weight'].to(dt)).split([rank, n, n], -1)
    delta = F.softplus(F.linear(low, p[f'{key}.dt_proj.weight'].to(dt),
                                p[f'{key}.dt_proj.bias'].to(dt)))
    y = scan(x, delta, -torch.exp(p[f'{key}.A_log'].to(dt)), Bm, Cm, p[f'{key}.D'].to(dt))
    return F.linear(y * F.silu(z), p[f'{key}.out_proj.weight'].to(dt))


def mamba_layer(x, p: dict, key: str, cfg: dict, prec):
    """NCHW ``x`` plus the Mamba block over its LayerNorm'd pixels."""
    c = x.shape[1]
    seq = x.flatten(2).transpose(1, 2)                               # [n, h*w, c]
    h = F.layer_norm(seq, (c,), p[f'{key}.norm.weight'].to(prec.dtype),
                     p[f'{key}.norm.bias'].to(prec.dtype), LN_EPS)
    out = seq + mamba(h, p, f'{key}.mamba', cfg, prec)
    return out.transpose(1, 2).reshape(x.shape)


def levels(p: dict, x, cfg: dict, prec):
    """Decoder levels '0' (input resolution) and '1' (half) of NCHW ``x``."""
    x = F.relu(prec.bn(cpn.conv(x, p, 'core.backbone.body.0.0', prec, stride=2), p,
                       'core.backbone.body.0.1'))
    feats = [x]
    x = F.max_pool2d(x, 3, 2, 1)
    blocks = _layer_keys(cfg)
    start = 0
    for i, count in enumerate(cfg['layers']):
        for key, _, _, stride in blocks[start:start + count]:
            x = _bottleneck(x, p, key, prec, stride, cfg['groups'])
        start += count
        x = mamba_layer(x, p, f'{PREFIX}{i + 1}', cfg, prec)
        feats.append(x)
    enc = encoder_channels(cfg)
    res = cpn.unet_decoder(feats, p, prec, [0] + enc, 1, 'core.backbone.unet')
    return {'0': res[0], '1': res[1]}
