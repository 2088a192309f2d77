"""The reference's initialization of a new CPN's convolutions.

Counterpart of ``celldetection_tpu/util/init.py``: the scheme table
(``FAMILY_SCHEMES``), ``detect_encoder_family`` and ``_resolve_scheme``
(84-128), applied over ``named_modules`` instead of a flax tree. Each
convolution's scheme follows from its JAX path (``util.weights._jax_path``):

- inside the UNet and FPN decoders (``unet``, ``fpn``): ``kaiming_uniform_(a=1)``,
  ``U(+-sqrt(3 / fan_in))`` kernels and zero biases, the reference's own
  re-initialization (``celldetection/models/unet.py:171-176``,
  ``fpn.py:125-129``);
- everywhere else in the port's models (the U-Net and ResNet encoders and
  the heads): ``torch_conv``, torch's default ``U(+-1 / sqrt(fan_in))`` for
  kernels and biases, which a new ``nn.Conv2d`` already holds and is left as
  it is.

The re-drawn values come from an explicit ``torch.Generator`` on the CPU, so
a model's decoder is the same on every device for one seed. They cannot equal
the JAX package's draws, which come from ``jax.random``.
"""
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .weights import _jax_path

__all__ = ['torch_init_', 'module_schemes', 'detect_encoder_family', 'FAMILY_SCHEMES']

# encoder family -> scheme for the encoder ('body') subtree
FAMILY_SCHEMES = {
    'resnet': 'torch_conv',        # reference resnet.py: torch defaults
    'unet_encoder': 'torch_conv',  # UNetEncoder: torch defaults
    'convnext': 'trunc_normal_02',
    'densenet': 'kaiming_normal_fan_in',
    'mobilenetv3': 'kaiming_normal_fan_out',
}


def detect_encoder_family(backbone) -> Optional[str]:
    """Best-effort encoder family from the backbone's ``body`` module class."""
    body = getattr(backbone, 'body', None)
    probe = body if body is not None else backbone
    name = (type(probe).__name__ + ' ' + type(probe).__module__).lower()
    for fam in ('convnext', 'densenet', 'mobilenetv3'):
        if fam in name:
            return fam
    if 'resnet' in name or 'resnext' in name:
        return 'resnet'
    if 'unetencoder' in name:
        return 'unet_encoder'
    return None


def _resolve_scheme(path: Tuple[str, ...], encoder_family: Optional[str]) -> str:
    parts = [p.lower() for p in path]
    # decoder subtrees (GeneralizedUNet / FeaturePyramidNetwork): the
    # reference re-inits every conv inside with kaiming_uniform(a=1) + zero
    # bias, regardless of encoder family
    if 'unet' in parts or 'fpn' in parts:
        return 'kaiming_uniform_a1'
    if 'body' in parts and encoder_family is not None:
        return FAMILY_SCHEMES.get(encoder_family, 'torch_conv')
    return 'torch_conv'


def module_schemes(model: nn.Module) -> Dict[str, Tuple[Tuple[str, ...], str]]:
    """``{module name: (flax path of the module, scheme)}`` for every
    convolution of a port CPN."""
    backbone = model.core.backbone
    family = detect_encoder_family(backbone)
    encoder = 'resnet' if family == 'resnet' else 'unet'
    fused = bool(getattr(getattr(backbone, 'body', None), 'fused_initial', False))
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d):
            _, path, _ = _jax_path(f'{name}.weight', encoder, fused)
            out[name] = (path[:-1], _resolve_scheme(path[:-1], family))
    return out


@torch.no_grad()
def torch_init_(model: nn.Module, generator: Optional[torch.Generator] = None,
                seed: int = 0) -> nn.Module:
    """Re-draw ``model``'s convolutions to the reference's init, in place.

    ``generator``: a CPU ``torch.Generator`` for the draws; one seeded with
    ``seed`` when None. Modules are visited in ``named_modules`` order.
    """
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    modules = dict(model.named_modules())
    for name, (_, scheme) in module_schemes(model).items():
        m = modules[name]
        if scheme == 'torch_conv':       # what a new nn.Conv2d holds already
            continue
        if scheme != 'kaiming_uniform_a1':
            raise NotImplementedError(f'init scheme {scheme} of {name}: its encoder family is '
                                      f'not ported yet')
        fan_in = m.weight[0].numel()
        bound = float(np.sqrt(3.0 / fan_in))
        w = torch.empty(m.weight.shape, dtype=torch.float32)
        w.uniform_(-bound, bound, generator=generator)
        m.weight.copy_(w)
        if m.bias is not None:
            m.bias.zero_()
    return model
