"""Plain reference of ``cpn_convnext_large_unet``: CpnConvNeXtLargeUNet of
celldetection v0.4.9 (``celldetection/models/cpn.py:1799``; the encoder
``models/convnext.py:348``, the U-Net ``models/unet.py:750-790``), the
ConvNeXt-Large of Liu et al. 2022 (arXiv:2201.03545).

The encoder: a 4x4 stride-4 stem convolution and a LayerNorm over the
channels, then four stages of (3, 3, 27, 3) blocks at (192, 384, 768, 1536)
channels; each stage after the first starts with a downsample (LayerNorm,
then a 2x2 stride-2 convolution). A block:

    x + γ ⊙ Linear₂(GELU(Linear₁(LN(dwconv7x7(x)))))

with a depthwise 7x7 convolution (bias), a LayerNorm over the channels
(epsilon 1e-6, weight and bias), a 4x MLP (both linears with bias), the
exact GELU and the per-channel layer scale γ. The four stages feed the
decoder of :func:`.cpn.unet_decoder` with two bridge levels, as the encoder
starts at stride 4: the heads see 192 channels at half the input's
resolution and the refinement head 192 at full resolution.

Every product runs in the precision's type: the convolutions through
:class:`.cpn.Precision`, the MLP's linears through :func:`linear`, which
under ``fp8`` rounds both operands to float8 e4m3 with one scale a tensor,
as the convolutions are, so the fp8 control is a control of the MLP too.
The LayerNorms, the GELU and the layer scale run in the precision's type.

Departures from the source:

- the stem and the downsamples pad nothing: the tiles' sides are multiples
  of 32 (the program pads as flax's ``'SAME'`` does, which is no padding at
  such sides);
- no stochastic depth, which is the identity at inference;
- the layer scale is drawn, not the published 1e-6, which would hide every
  block behind its residual (:func:`init_weights`).
"""
import torch
import torch.nn.functional as F

from . import cpn

LN_EPS = 1e-6
BODY = 'core.backbone.body'
LAYER_SCALE = (0.05, 0.15)      # γ ~ U(0.05, 0.15), as the program's init_jax_variables draws it


def decoder_channels(cfg: dict):
    """The decoder's output channels, finest first: the two bridge levels take the first stage's."""
    return [cfg['channels'][0]] + list(cfg['channels'])


def _block_keys(cfg: dict):
    """(key, stage, channels) of every block."""
    return [(f'{BODY}.stage{i}_block{j}', i, c)
            for i, (depth, c) in enumerate(zip(cfg['depths'], cfg['channels']))
            for j in range(depth)]


def shapes(cfg: dict) -> dict:
    out = {}
    ch = list(cfg['channels'])
    cpn.conv_shapes(out, f'{BODY}.stem_conv', cfg['in_channels'], ch[0], 4)
    out[f'{BODY}.stem_norm.weight'] = out[f'{BODY}.stem_norm.bias'] = (ch[0],)
    for i in range(1, len(ch)):
        out[f'{BODY}.down{i}_norm.weight'] = out[f'{BODY}.down{i}_norm.bias'] = (ch[i - 1],)
        cpn.conv_shapes(out, f'{BODY}.down{i}_conv', ch[i - 1], ch[i], 2)
    for key, _, c in _block_keys(cfg):
        cpn.conv_shapes(out, f'{key}.dwconv', c, c, 7, groups=c)
        out[f'{key}.norm.weight'] = out[f'{key}.norm.bias'] = (c,)
        out[f'{key}.mlp0.weight'], out[f'{key}.mlp0.bias'] = (4 * c, c), (4 * c,)
        out[f'{key}.mlp1.weight'], out[f'{key}.mlp1.bias'] = (c, 4 * c), (c,)
        out[f'{key}.layer_scale'] = (c,)
    dec = decoder_channels(cfg)
    cpn.decoder_shapes(out, 'core.backbone.unet', [0, 0] + ch, dec)
    cpn.head_shapes(out, dec, cfg)
    return out


def init_weights(p: dict, cfg: dict, gen: torch.Generator):
    """Each block's layer scale γ drawn from U(:data:`LAYER_SCALE`), in place."""
    lo, hi = LAYER_SCALE
    for key, _, c in _block_keys(cfg):
        leaf = f'{key}.layer_scale'
        u = torch.rand(c, generator=gen, device=p[leaf].device)
        p[leaf] = lo + (hi - lo) * u


def linear(x, w, b, prec):
    """``x @ w.T + b`` over the last axis in the precision's type; under fp8 both
    operands rounded to float8 e4m3 (one scale a tensor), products summed in float32."""
    if prec.name == 'fp8':
        xq, sx = cpn._fp8(x)
        wq, sw = cpn._fp8(w)
        return (F.linear(xq, wq) * (sx * sw) + b.float()).to(prec.dtype)
    return F.linear(x, w.to(prec.dtype), b.to(prec.dtype))


def layer_norm(x, p, key, prec):
    """LayerNorm over the last axis (epsilon :data:`LN_EPS`)."""
    return F.layer_norm(x, x.shape[-1:], p[f'{key}.weight'].to(prec.dtype),
                        p[f'{key}.bias'].to(prec.dtype), LN_EPS)


def channel_norm(x, p, key, prec):
    """LayerNorm over the channels of NCHW ``x``."""
    return layer_norm(x.permute(0, 2, 3, 1), p, key, prec).permute(0, 3, 1, 2)


def block(x, p, key, prec):
    """One ConvNeXt block of NCHW ``x`` (see the module's docstring)."""
    w = p[f'{key}.dwconv.weight']
    y = prec.conv(x, w, p[f'{key}.dwconv.bias'], 1, 3, w.shape[0]).permute(0, 2, 3, 1)
    y = layer_norm(y, p, f'{key}.norm', prec)
    y = F.gelu(linear(y, p[f'{key}.mlp0.weight'], p[f'{key}.mlp0.bias'], prec))
    y = linear(y, p[f'{key}.mlp1.weight'], p[f'{key}.mlp1.bias'], prec)
    y = y * p[f'{key}.layer_scale'].to(prec.dtype)
    return x + y.permute(0, 3, 1, 2)


def encoder(p: dict, x, cfg: dict, prec):
    """The four stages' NCHW outputs (strides 4 to 32) of NCHW ``x``."""
    x = prec.conv(x, p[f'{BODY}.stem_conv.weight'], p[f'{BODY}.stem_conv.bias'], 4, 0)
    x = channel_norm(x, p, f'{BODY}.stem_norm', prec)
    feats, keys = [], _block_keys(cfg)
    for i in range(len(cfg['depths'])):
        if i > 0:
            x = channel_norm(x, p, f'{BODY}.down{i}_norm', prec)
            x = prec.conv(x, p[f'{BODY}.down{i}_conv.weight'], p[f'{BODY}.down{i}_conv.bias'],
                          2, 0)
        for key, stage, _ in keys:
            if stage == i:
                x = block(x, p, key, prec)
        feats.append(x)
    return feats


def levels(p: dict, x, cfg: dict, prec):
    """Decoder levels '0' (input resolution) and '1' (half) of NCHW ``x``."""
    feats = encoder(p, x, cfg, prec)
    res = cpn.unet_decoder(feats, p, prec, [0, 0] + list(cfg['channels']), 2,
                           'core.backbone.unet')
    return {'0': res[0], '1': res[1]}
