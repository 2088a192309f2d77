"""Plain reference of ``cpn_resnext101_unet``: CpnResNeXt101UNet of
celldetection v0.4.9 (``celldetection/models/cpn.py:930``; ``models/unet.py``:
``ResNeXt101UNet``; the encoder is torchvision's ``resnext101_32x8d``).

The encoder: a 7x7 stride-2 stem (conv, batch norm, ReLU) as its own level,
then a 3x3 stride-2 max-pool and layers of (3, 4, 23, 3) bottleneck blocks
(1x1 conv, grouped 3x3 conv with the layer's stride, 1x1 conv to 4x planes,
each with a batch norm; ReLU after the first two and after the residual sum;
a strided 1x1 conv and batch norm on the shortcut where the shape changes).
The decoder of :func:`.cpn.unet_decoder` with one bridge level, because the
encoder's first level is at stride 2. The input is clamped to [0, 1] first.
"""
import torch.nn.functional as F

from . import cpn


def encoder_channels(cfg: dict):
    b, e = cfg['stem_channels'], cfg['expansion']
    return [b] + [b * 2 ** i * e for i in range(len(cfg['layers']))]


def _layer_keys(cfg: dict):
    """(key, in, planes, stride) of every block; layer i lives at ``body.{i+1}``."""
    out, prev = [], cfg['stem_channels']
    for i, blocks in enumerate(cfg['layers']):
        planes = cfg['stem_channels'] * 2 ** i
        base = 'core.backbone.body.1.1' if i == 0 else f'core.backbone.body.{i + 1}'
        for j in range(blocks):
            out.append((f'{base}.{j}', prev, planes, (1 if i == 0 else 2) if j == 0 else 1))
            prev = planes * cfg['expansion']
    return out


def shapes(cfg: dict) -> dict:
    out = {}
    s = cfg['stem_channels']
    cpn.conv_shapes(out, 'core.backbone.body.0.0', cfg['in_channels'], s, 7, bias=False)
    cpn.bn_shapes(out, 'core.backbone.body.0.1', s)
    g = cfg['groups']
    for key, cin, planes, stride in _layer_keys(cfg):
        width = int(planes * cfg['width_per_group'] / 64.) * g
        c_out = planes * cfg['expansion']
        cpn.conv_shapes(out, f'{key}.conv1', cin, width, 1, bias=False)
        cpn.bn_shapes(out, f'{key}.bn1', width)
        cpn.conv_shapes(out, f'{key}.conv2', width, width, 3, bias=False, groups=g)
        cpn.bn_shapes(out, f'{key}.bn2', width)
        cpn.conv_shapes(out, f'{key}.conv3', width, c_out, 1, bias=False)
        cpn.bn_shapes(out, f'{key}.bn3', c_out)
        if stride != 1 or cin != c_out:
            cpn.conv_shapes(out, f'{key}.downsample.0', cin, c_out, 1, bias=False)
            cpn.bn_shapes(out, f'{key}.downsample.1', c_out)
    enc = encoder_channels(cfg)
    cpn.decoder_shapes(out, 'core.backbone.unet', [0] + enc, enc)
    cpn.head_shapes(out, enc, cfg)
    return out


def _bottleneck(x, p, key, prec, stride, groups):
    identity = x
    if f'{key}.downsample.0.weight' in p:
        identity = prec.bn(cpn.conv(x, p, f'{key}.downsample.0', prec, stride=stride), p,
                           f'{key}.downsample.1')
    y = F.relu(prec.bn(cpn.conv(x, p, f'{key}.conv1', prec), p, f'{key}.bn1'))
    y = F.relu(prec.bn(cpn.conv(y, p, f'{key}.conv2', prec, stride=stride, groups=groups), p,
                       f'{key}.bn2'))
    return F.relu(prec.bn(cpn.conv(y, p, f'{key}.conv3', prec), p, f'{key}.bn3') + identity)


def levels(p: dict, x, cfg: dict, prec):
    """Decoder levels '0' (input resolution) and '1' (half) of NCHW ``x``."""
    x = F.relu(prec.bn(cpn.conv(x, p, 'core.backbone.body.0.0', prec, stride=2), p,
                       'core.backbone.body.0.1'))
    feats = [x]
    x = F.max_pool2d(x, 3, 2, 1)
    layer = 0
    for key, _, _, stride in _layer_keys(cfg):
        li = 0 if key.startswith('core.backbone.body.1.1') else int(key.split('.')[3]) - 1
        if li != layer:
            feats.append(x)
            layer = li
        x = _bottleneck(x, p, key, prec, stride, cfg['groups'])
    feats.append(x)
    enc = encoder_channels(cfg)
    res = cpn.unet_decoder(feats, p, prec, [0] + enc, 1, 'core.backbone.unet')
    return {'0': res[0], '1': res[1]}
