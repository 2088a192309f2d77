"""Weights between the JAX package's variables and the port's state dict.

``state_dict_from_jax`` is the port's own copy of
``celldetection_tpu/util/torch_import.py:export_torch_state_dict`` (lines
280-400) for the encoders the port has: the U-Net encoder and the ResNet
body (348-398), the U-Net decoder with its bias-free bridges, and the FPN
(348-356). JAX variables, as nested dicts of numpy arrays (``{'params': ...,
'batch_stats': ...}``), become the reference torch layout (conv HWIO → OIHW;
BatchNorm ``scale``/``bias``/``mean``/``var`` →
``weight``/``bias``/``running_mean``/``running_var``) under the keys the port's
modules carry, so ``load_state_dict(..., strict=True)`` takes it.
``jax_variables_from_state_dict`` is its inverse (OIHW back to HWIO), the
tree that flax's ``from_bytes`` restores into a JAX model.
``init_jax_variables`` makes seeded random weights in the JAX layout for a
port model.

A ResNet body's JAX variables are the same for ``fused_initial`` True and
False (only the torch keys of the stem and ``layer1`` differ), so the layout
is an explicit argument, False by default as in every zoo constructor.
"""
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ['state_dict_from_jax', 'jax_variables_from_state_dict', 'init_jax_variables',
           'detect_encoder_layout']

_NORM_LEAVES = {('params', 'scale'): 'weight', ('params', 'bias'): 'bias',
                ('batch_stats', 'mean'): 'running_mean', ('batch_stats', 'var'): 'running_var'}
_NORM_PATHS = {v: k for k, v in _NORM_LEAVES.items()}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _two_conv_suffix(coll: str, p) -> str:
    """TwoConvNormRelu flax path ``[block0|block1, conv|norm, ..., leaf]`` → ``'<idx>.<leaf>'``."""
    b = {'block0': 0, 'block1': 3}[p[0]]
    if p[1] == 'conv':
        return f'{b}.{"weight" if p[-1] == "kernel" else "bias"}'
    return f'{b + 1}.{_NORM_LEAVES[(coll, p[-1])]}'


def _resnet_stage(layer: int, fused_initial: bool) -> str:
    """The torch prefix of ResNet ``layer<layer>`` under ``backbone.body``."""
    if layer == 1:
        return '0.4' if fused_initial else '1.1'
    return str(layer - 1 if fused_initial else layer)


def _port_key(coll: str, path: Tuple[str, ...], fused_initial: bool = False) -> str:
    """(collection, flax path) → the port's state-dict key."""
    p = list(path)
    conv_leaf = 'weight' if p[-1] == 'kernel' else 'bias'
    if p[0].endswith('_head'):
        if p[1] in ('conv0', 'conv1'):
            return f'core.{p[0]}.block.{0 if p[1] == "conv0" else 4}.{conv_leaf}'
        if p[1] == 'norm':
            return f'core.{p[0]}.block.1.{_NORM_LEAVES[(coll, p[-1])]}'
    elif p[:2] == ['backbone', 'unet']:
        m = re.fullmatch(r'(inner|layer)(\d+)', p[2])
        if m and m.group(1) == 'inner':
            return f'core.backbone.unet.inner_blocks.{int(m.group(2)) - 1}.{conv_leaf}'
        if m:
            return f'core.backbone.unet.layer_blocks.{m.group(2)}.{_two_conv_suffix(coll, p[3:])}'
        if p[2] == 'out_layer':
            return f'core.backbone.unet.out_layer.{conv_leaf}'
    elif p[:2] == ['backbone', 'fpn']:
        m = re.fullmatch(r'(inner|layer)(\d+)', p[2])
        if m and p[3] == 'conv':
            return f'core.backbone.fpn.{m.group(1)}_blocks.{m.group(2)}.0.{conv_leaf}'
        if m and p[3] == 'norm':
            return f'core.backbone.fpn.{m.group(1)}_blocks.{m.group(2)}.1.' \
                   f'{_NORM_LEAVES[(coll, p[-1])]}'
    elif p[:2] == ['backbone', 'body']:
        m = re.fullmatch(r'block(\d+)', p[2])
        if m:
            i = int(m.group(1))
            pool = '1.' if i > 0 else ''   # body.<i> = Sequential(pool, block) for i > 0
            return f'core.backbone.body.{i}.{pool}{_two_conv_suffix(coll, p[3:])}'
        if p[2] == 'conv1':
            return 'core.backbone.body.0.0.weight'
        if p[2] == 'bn1':
            return f'core.backbone.body.0.1.{_NORM_LEAVES[(coll, p[-1])]}'
        m = re.fullmatch(r'layer(\d+)', p[2])
        b = re.fullmatch(r'block(\d+)', p[3]) if m else None
        if b:
            prefix = f'core.backbone.body.{_resnet_stage(int(m.group(1)), fused_initial)}.' \
                     f'{b.group(1)}'
            if re.fullmatch(r'conv\d', p[4]):
                return f'{prefix}.{p[4]}.weight'
            if re.fullmatch(r'bn\d', p[4]):
                return f'{prefix}.{p[4]}.{_NORM_LEAVES[(coll, p[-1])]}'
            if p[4] == 'downsample_conv':
                return f'{prefix}.downsample.0.weight'
            if p[4] == 'downsample_norm':
                return f'{prefix}.downsample.1.{_NORM_LEAVES[(coll, p[-1])]}'
    raise KeyError(f'no port module for {coll}/{"/".join(path)} (not ported yet?)')


def _jax_path(key: str, encoder: str = 'unet',
              fused_initial: bool = False) -> Tuple[str, Tuple[str, ...], bool]:
    """The port's state-dict key → (collection, flax path, is conv kernel).

    ``encoder`` (``'unet'`` or ``'resnet'``) names the body: the stem's keys
    ``body.0.0``/``body.0.1`` are a U-Net block's convolution and norm, or a
    ResNet's ``conv1``/``bn1``; ``fused_initial`` the ResNet body's layout.
    """
    def conv(prefix, leaf):
        return 'params', prefix + ('kernel' if leaf == 'weight' else 'bias',), leaf == 'weight'

    def norm(prefix, leaf):
        coll, name = _NORM_PATHS[leaf]
        return coll, prefix + ('norm', name), False

    def two_conv(prefix, idx, leaf):
        block = ('block0', 'block0', None, 'block1', 'block1')[idx]
        if idx in (0, 3):
            return conv(prefix + (block, 'conv'), leaf)
        return norm(prefix + (block, 'norm'), leaf)

    m = re.fullmatch(r'core\.(\w+_head)\.block\.([014])\.(\w+)', key)
    if m:
        head, idx, leaf = m.groups()
        if idx == '1':
            return norm((head, 'norm'), leaf)
        return conv((head, 'conv0' if idx == '0' else 'conv1'), leaf)
    m = re.fullmatch(r'core\.backbone\.unet\.inner_blocks\.(\d+)\.(weight|bias)', key)
    if m:
        return conv(('backbone', 'unet', f'inner{int(m.group(1)) + 1}'), m.group(2))
    m = re.fullmatch(r'core\.backbone\.unet\.layer_blocks\.(\d+)\.([0134])\.(\w+)', key)
    if m:
        return two_conv(('backbone', 'unet', f'layer{m.group(1)}'), int(m.group(2)), m.group(3))
    m = re.fullmatch(r'core\.backbone\.unet\.out_layer\.(weight|bias)', key)
    if m:
        return conv(('backbone', 'unet', 'out_layer'), m.group(1))
    m = re.fullmatch(r'core\.backbone\.fpn\.(inner|layer)_blocks\.(\d+)\.([01])\.(\w+)', key)
    if m:
        prefix = ('backbone', 'fpn', f'{m.group(1)}{m.group(2)}')
        return conv(prefix + ('conv',), m.group(4)) if m.group(3) == '0' else \
            norm(prefix + ('norm',), m.group(4))
    if encoder == 'unet':
        m = re.fullmatch(r'core\.backbone\.body\.(\d+)\.(1\.)?([0134])\.(\w+)', key)
        if m and (int(m.group(1)) > 0) == bool(m.group(2)):
            return two_conv(('backbone', 'body', f'block{m.group(1)}'), int(m.group(3)),
                            m.group(4))
    elif encoder == 'resnet':
        body = ('backbone', 'body')
        if key == 'core.backbone.body.0.0.weight':
            return conv(body + ('conv1',), 'weight')
        m = re.fullmatch(r'core\.backbone\.body\.0\.1\.(\w+)', key)
        if m:
            return norm(body + ('bn1',), m.group(1))
        m = re.fullmatch(r'core\.backbone\.body\.(\d(?:\.\d)?)\.(\d+)\.'
                         r'(conv\d|bn\d|downsample\.0|downsample\.1)\.(\w+)', key)
        layer = {_resnet_stage(i, fused_initial): i for i in range(1, 5)}.get(m.group(1)) \
            if m else None
        if layer:
            prefix = body + (f'layer{layer}', f'block{m.group(2)}')
            kind = m.group(3).replace('downsample.0', 'downsample_conv').replace(
                'downsample.1', 'downsample_norm')
            if kind.startswith(('bn', 'downsample_norm')):
                return norm(prefix + (kind,), m.group(4))
            return conv(prefix + (kind,), m.group(4))
    raise KeyError(f'no JAX variable for port key {key}')


def state_dict_from_jax(variables, fused_initial: bool = False) -> Dict[str, torch.Tensor]:
    """JAX CPN variables (nested dicts of arrays) → the port's state dict (CPU tensors).

    ``fused_initial``: the layout of a ResNet body (ignored for others).
    """
    out = {}
    for coll, tree in variables.items():
        for path, v in _flatten(tree):
            key = _port_key(coll, path, fused_initial)
            t = torch.from_numpy(np.array(v))   # an owned copy
            if path[-1] == 'kernel':
                # HWIO -> OIHW, in torch: a threaded copy, where numpy's is not
                t = t.permute(3, 2, 0, 1).contiguous()
            out[key] = t
    return out


def detect_encoder_layout(state_dict) -> Tuple[str, bool]:
    """Infer ``(encoder, fused_initial)`` from torch-layout keys.

    A ResNet body contains ``convN``/``bnN`` leaf names; a fused stem puts
    layer1 at ``body.0.4`` while the reference's UNet/FPN default
    (``fused_initial=False``) puts it under ``body.1.1``.
    """
    body = [re.sub(r'^(core\.)?backbone\.body\.', '', k) for k in state_dict
            if re.match(r'(core\.)?backbone\.body\.', k)]
    encoder = 'resnet' if any('.conv1.' in k or '.bn1.' in k or 'downsample' in k
                              for k in body) else 'unet'
    fused = any(k.startswith('0.4.') for k in body)
    return encoder, fused


def _set_path(tree: dict, path, value):
    for name in path[:-1]:
        tree = tree.setdefault(name, {})
    tree[path[-1]] = value


def jax_variables_from_state_dict(state_dict, fused_initial: bool = False,
                                  encoder: Optional[str] = None) -> dict:
    """The port's state dict → JAX CPN variables ``{'params', 'batch_stats'}``
    as nested dicts of numpy arrays (conv OIHW → HWIO): the inverse of
    :func:`state_dict_from_jax`.

    ``fused_initial``: the layout of a ResNet body; ``encoder`` (``'unet'``
    or ``'resnet'``) is read from the keys when None.
    """
    if encoder is None:
        encoder, _ = detect_encoder_layout(state_dict)
    variables = {}
    for key, t in state_dict.items():
        coll, path, is_kernel = _jax_path(key, encoder, fused_initial)
        t = torch.as_tensor(t).detach()
        if is_kernel:
            t = t.permute(2, 3, 1, 0)   # OIHW -> HWIO, on the tensor's device
        _set_path(variables.setdefault(coll, {}), path, t.contiguous().cpu().numpy())
    return variables


def init_jax_variables(model: torch.nn.Module, seed: int = 0) -> dict:
    """Seeded random weights for ``model`` as JAX-layout variables (numpy, fp32).

    Conv kernels are He-uniform (``sqrt(6 / fan_in)``), which keeps activation
    scale through ReLU stacks; conv biases and BatchNorm statistics are small
    perturbations around the identity. ``state_dict_from_jax`` of the result
    loads into ``model`` with ``strict=True`` (given the ``fused_initial`` of
    a ResNet body, which this function reads from ``model``).
    """
    from ..models.resnet import ResNetEncoder   # the models import this package
    body = model.core.backbone.body
    resnet = isinstance(body, ResNetEncoder)
    encoder, fused_initial = ('resnet', body.fused_initial) if resnet else ('unet', False)
    rng = np.random.RandomState(seed)
    variables = {}
    for key, t in model.state_dict().items():
        coll, path, is_kernel = _jax_path(key, encoder, fused_initial)
        shape = tuple(t.shape)
        if is_kernel:
            o, i, kh, kw = shape
            bound = np.sqrt(6.0 / (i * kh * kw))
            v = rng.uniform(-bound, bound, (kh, kw, i, o))
        elif path[-1] in ('scale', 'var'):
            v = rng.uniform(0.5, 1.5, shape)
        else:   # conv and norm biases, running means
            v = 0.1 * rng.randn(*shape)
        _set_path(variables.setdefault(coll, {}), path, v.astype(np.float32))
    return variables
