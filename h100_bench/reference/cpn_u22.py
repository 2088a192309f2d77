"""Plain reference of ``cpn_u22``: CpnU22 of celldetection v0.4.9
(``celldetection/models/cpn.py:772``; ``models/unet.py``: ``U22``).

The U22 backbone is a U-Net of 22 convolutions over five resolutions: an
encoder of ``depth`` U-Net blocks with a 2x2 max-pool before each but the
first, ``base_channels * 2**i`` channels at level i, and the decoder of
:func:`.cpn.unet_decoder`. The input is clamped to [0, 1] first.
"""
import torch.nn.functional as F

from . import cpn


def channels(cfg: dict):
    return [cfg['base_channels'] * 2 ** i for i in range(cfg['depth'])]


def shapes(cfg: dict) -> dict:
    """Every parameter and buffer, by its published name, with its shape."""
    out, prev = {}, cfg['in_channels']
    ch = channels(cfg)
    for i, c in enumerate(ch):
        cpn.two_conv_shapes(out, f'core.backbone.body.{i}' + ('.1' if i else ''), prev, c)
        prev = c
    cpn.decoder_shapes(out, 'core.backbone.unet', ch, ch)
    cpn.head_shapes(out, ch, cfg)
    return out


def levels(p: dict, x, cfg: dict, prec):
    """Decoder levels '0' (input resolution) and '1' (half) of NCHW ``x``."""
    feats = []
    for i in range(cfg['depth']):
        if i:
            x = F.max_pool2d(x, 2)
        x = cpn.two_conv(x, p, f'core.backbone.body.{i}' + ('.1' if i else ''), prec)
        feats.append(x)
    res = cpn.unet_decoder(feats, p, prec, channels(cfg), 0, 'core.backbone.unet')
    return {'0': res[0], '1': res[1]}
