"""Weights between the JAX package's variables and the port's state dict.

``state_dict_from_jax`` is the port's own copy of
``celldetection_tpu/util/torch_import.py:export_torch_state_dict`` (lines
280-400) for the encoders it covers: the U-Net encoder and the ResNet body
(348-398), the U-Net decoder with its bias-free bridges, the FPN
(348-356), the heads and the ``*_fuse`` modules (308-328), under the
reference torch layout; ``ResBlock`` takes
``TwoConvNormRelu``'s indices and ``downsample.{0,1}``. The JAX package
defines no torch layout for the later families (the ConvNeXt, DenseNet and
MobileNetV3 bodies, ``Ppm`` as ``body.ppm``, the MaNet ``decoder``): their
port modules carry the JAX module names, so their key is the flax path
joined by dots (:func:`_flax_key`). JAX variables, as nested dicts of numpy
arrays (``{'params': ..., 'batch_stats': ...}``), become torch tensors (conv
kernels HWIO → OIHW and DHWIO → OIDHW, a depthwise ``[7, 7, 1, C]`` →
``[C, 1, 7, 7]``;
``Dense`` kernels ``[in, out]`` → ``nn.Linear``'s ``[out, in]``; norm
``scale``/``bias``/``mean``/``var`` → ``weight``/``bias``/``running_mean``/
``running_var``; ``layer_scale``, GRN's ``gamma``/``beta`` and the PAB's
``beta`` as they are; a Mamba's ``conv1d`` kernel ``[d_conv, 1, C]`` →
``Conv1d``'s ``[C, 1, d_conv]``, its ``A_log`` and ``D`` as they are; a
trainable ``Filter2d``'s ``kernel`` (:func:`_is_filter`) as it is; the
secondary blocks of a ResNet body or a U-Net decoder, ``secondary{i}``, under
their flax paths, and so the blocks of ``models/commons.py`` that carry the
JAX names: ``SqueezeExcitation``'s ``fc0``/``fc1``, ``SelfAttention``'s
``in_conv``, ``proj_a``, ``proj_b``, ``proj``, ``out_conv`` and ``beta``,
``LayerNorm2d``'s ``ln``, ``AdditiveNoise``'s ``weight`` and
``DynamicTanh``'s ``alpha``, ``weight`` and ``bias``, where a 1-D
``weight`` outside a norm is a parameter of that name, not a kernel; a
``BottleneckBlock`` of a U-Net encoder or decoder, found by its ``block2``,
keeps its flax names ``block0-2``/``downsample`` under the block's torch
prefix) under the keys the port's modules carry, so
``load_state_dict(..., strict=True)`` takes it.
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
           'detect_encoder_layout', 'body_layout']

_NORM_LEAVES = {('params', 'scale'): 'weight', ('params', 'bias'): 'bias',
                ('batch_stats', 'mean'): 'running_mean', ('batch_stats', 'var'): 'running_var'}
_NORM_PATHS = {v: k for k, v in _NORM_LEAVES.items()}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


_FLAX_LEAVES = {'kernel': 'weight', 'scale': 'weight', 'mean': 'running_mean',
                'var': 'running_var'}


def _is_filter(path: Tuple[str, ...]) -> bool:
    """The ``kernel`` of a trainable ``Filter2d``, ``[kh, kw]`` or ``[num, kh, kw]``
    in both packages: a module that flax names ``Filter2d_<i>`` (the class's
    name when its parent gives none) or ``module`` (``UpFilter2d``'s field);
    no convolution or ``Dense`` of the JAX package carries either name."""
    return path[-1] == 'kernel' and re.fullmatch(r'Filter2d_\d+|module', path[-2]) is not None


def _flax_suffix(path) -> str:
    """A flax path joined by dots, with the torch leaf name."""
    return '.'.join(tuple(path[:-1]) + (_FLAX_LEAVES.get(path[-1], path[-1]),))


def _flax_key(path: Tuple[str, ...]) -> str:
    """A later family's key: the flax path joined by dots, with the torch leaf name."""
    return 'core.' + _flax_suffix(path)


def _flax_path(key: str, ndim: Optional[int] = None) -> Tuple[str, Tuple[str, ...], bool]:
    """The inverse of :func:`_flax_key`: a norm's ``weight`` (of a module named
    ``norm``, ``*_norm`` or ``ln``, every norm's flax name) is its ``scale``;
    another ``weight`` is a ``kernel``, unless ``ndim`` says it is 1-D (a
    kernel never is): then it is a parameter named ``weight``
    (``AdditiveNoise``, ``DynamicTanh``)."""
    parts = key.split('.')[1:]
    module, leaf = parts[-2], parts[-1]
    is_norm = module in ('norm', 'ln') or module.endswith('_norm')
    if leaf == 'weight' and not (ndim == 1 and not is_norm):
        leaf = 'scale' if is_norm else 'kernel'
    coll = 'batch_stats' if leaf in ('running_mean', 'running_var') else 'params'
    leaf = {'running_mean': 'mean', 'running_var': 'var'}.get(leaf, leaf)
    path = tuple(parts[:-1]) + (leaf,)
    return coll, path, leaf == 'kernel' and not _is_filter(path)


def _two_conv_suffix(coll: str, p) -> str:
    """TwoConvNormRelu (or ResBlock) flax path ``[block0|block1|downsample, conv|norm, ...,
    leaf]`` → ``'<idx>.<leaf>'``."""
    conv, norm = {'block0': ('0', '1'), 'block1': ('3', '4'),
                  'downsample': ('downsample.0', 'downsample.1')}[p[0]]
    if p[1] == 'conv':
        return f'{conv}.{"weight" if p[-1] == "kernel" else "bias"}'
    return f'{norm}.{_NORM_LEAVES[(coll, p[-1])]}'


def _resnet_stage(layer: int, fused_initial: bool) -> str:
    """The torch prefix of ResNet ``layer<layer>`` under ``backbone.body``."""
    if layer == 1:
        return '0.4' if fused_initial else '1.1'
    return str(layer - 1 if fused_initial else layer)


def _bottlenecks(variables) -> frozenset:
    """The flax paths of the U-Net encoder's and decoder's bottleneck blocks
    (``BottleneckBlock``): the blocks with a ``block2`` child."""
    level = {'body': r'block\d+', 'unet': r'layer\d+'}   # a U-Net encoder's and decoder's blocks
    return frozenset(path[:3] for tree in variables.values() for path, _ in _flatten(tree)
                     if len(path) > 4 and path[0] == 'backbone' and path[1] in level
                     and re.fullmatch(level[path[1]], path[2]) and path[3] == 'block2'
                     and path[4] in ('conv', 'norm'))


def _port_key(coll: str, path: Tuple[str, ...], fused_initial: bool = False,
              bottlenecks: frozenset = frozenset()) -> str:
    """(collection, flax path) → the port's state-dict key; ``bottlenecks``
    (:func:`_bottlenecks`) names the blocks that are bottleneck blocks."""
    p = list(path)
    conv_leaf = 'weight' if p[-1] == 'kernel' else 'bias'
    if tuple(p[:3]) in bottlenecks:
        i = re.fullmatch(r'(?:block|layer)(\d+)', p[2]).group(1)
        prefix = f'core.backbone.body.{i}.{"1." if int(i) > 0 else ""}' if p[1] == 'body' \
            else f'core.backbone.unet.layer_blocks.{i}.'
        return prefix + _flax_suffix(p[3:])
    if p[0].endswith('_fuse'):     # Fuse: conv 0, norm 1 (the reference's Fuse2d)
        if p[1] == 'conv':
            return f'core.{p[0]}.block.0.{conv_leaf}'
        if p[1] == 'norm':
            return f'core.{p[0]}.block.1.{_NORM_LEAVES[(coll, p[-1])]}'
    elif p[0].endswith('_head'):
        if p[1] in ('conv0', 'conv1'):
            return f'core.{p[0]}.block.{0 if p[1] == "conv0" else 4}.{conv_leaf}'
        if p[1] == 'norm':
            return f'core.{p[0]}.block.1.{_NORM_LEAVES[(coll, p[-1])]}'
    elif p[:2] == ['backbone', 'unet']:
        if p[2].startswith('secondary'):
            return _flax_key(path)
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
        if m and p[3] in ('block0', 'block1', 'downsample'):   # not a MobileNetV3 block
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
    if p[:2] in (['backbone', 'body'], ['backbone', 'decoder']):
        return _flax_key(path)
    raise KeyError(f'no port module for {coll}/{"/".join(path)} (not ported yet?)')


def _jax_path(key: str, encoder: str = 'unet', fused_initial: bool = False,
              ndim: Optional[int] = None) -> Tuple[str, Tuple[str, ...], bool]:
    """The port's state-dict key → (collection, flax path, is kernel); ``ndim``:
    the tensor's, which tells a 1-D ``weight`` parameter from a kernel.

    ``encoder`` (``'unet'`` or ``'resnet'``) names the layout of a body whose
    keys are numbered: the stem's keys ``body.0.0``/``body.0.1`` are a U-Net
    block's convolution and norm, or a ResNet's ``conv1``/``bn1``;
    ``fused_initial`` the ResNet body's layout. The keys of the later
    families (a named module under ``body``, and the MaNet ``decoder``) map
    back whatever the two say.
    """
    def conv(prefix, leaf):
        return 'params', prefix + ('kernel' if leaf == 'weight' else 'bias',), leaf == 'weight'

    def norm(prefix, leaf):
        coll, name = _NORM_PATHS[leaf]
        return coll, prefix + ('norm', name), False

    def two_conv(prefix, idx, leaf):
        """``idx``: a TwoConvNormRelu index (0, 1, 3, 4) or a ResBlock's ``downsample.{0,1}``."""
        if idx.startswith('downsample'):
            block, is_conv = 'downsample', idx.endswith('0')
        else:
            block, is_conv = ('block0', 'block0', None, 'block1', 'block1')[int(idx)], idx in '03'
        if is_conv:
            return conv(prefix + (block, 'conv'), leaf)
        return norm(prefix + (block, 'norm'), leaf)

    m = re.fullmatch(r'core\.(\w+_head)\.block\.([014])\.(\w+)', key)
    if m:
        head, idx, leaf = m.groups()
        if idx == '1':
            return norm((head, 'norm'), leaf)
        return conv((head, 'conv0' if idx == '0' else 'conv1'), leaf)
    m = re.fullmatch(r'core\.(\w+_fuse)\.block\.([01])\.(\w+)', key)
    if m:
        fuse, idx, leaf = m.groups()
        return conv((fuse, 'conv'), leaf) if idx == '0' else norm((fuse, 'norm'), leaf)
    m = re.fullmatch(r'core\.backbone\.unet\.inner_blocks\.(\d+)\.(weight|bias)', key)
    if m:
        return conv(('backbone', 'unet', f'inner{int(m.group(1)) + 1}'), m.group(2))
    if re.fullmatch(r'core\.backbone\.(body\.[A-Za-z]\w*|decoder|unet\.secondary\d+)\..*', key):
        return _flax_path(key, ndim)
    # a BottleneckBlock of the U-Net encoder or decoder: flax names under the block's prefix
    m = re.fullmatch(r'core\.backbone\.(?:body\.(\d+)\.(?:1\.)?|unet\.layer_blocks\.(\d+)\.)'
                     r'((?:block[012]|downsample)\.(?:conv|norm\.norm)\.\w+)', key)
    if m:
        block = ('body', f'block{m.group(1)}') if m.group(1) else ('unet', f'layer{m.group(2)}')
        coll, path, is_kernel = _flax_path('core.' + m.group(3))
        return coll, ('backbone',) + block + path, is_kernel
    m = re.fullmatch(r'core\.backbone\.unet\.layer_blocks\.(\d+)\.([0134]|downsample\.[01])'
                     r'\.(\w+)', key)
    if m:
        return two_conv(('backbone', 'unet', f'layer{m.group(1)}'), m.group(2), m.group(3))
    m = re.fullmatch(r'core\.backbone\.unet\.out_layer\.(weight|bias)', key)
    if m:
        return conv(('backbone', 'unet', 'out_layer'), m.group(1))
    m = re.fullmatch(r'core\.backbone\.fpn\.(inner|layer)_blocks\.(\d+)\.([01])\.(\w+)', key)
    if m:
        prefix = ('backbone', 'fpn', f'{m.group(1)}{m.group(2)}')
        return conv(prefix + ('conv',), m.group(4)) if m.group(3) == '0' else \
            norm(prefix + ('norm',), m.group(4))
    if encoder == 'unet':
        m = re.fullmatch(r'core\.backbone\.body\.(\d+)\.(1\.)?([0134]|downsample\.[01])'
                         r'\.(\w+)', key)
        if m and (int(m.group(1)) > 0) == bool(m.group(2)):
            return two_conv(('backbone', 'body', f'block{m.group(1)}'), m.group(3), m.group(4))
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
    bottlenecks = _bottlenecks(variables)
    for coll, tree in variables.items():
        for path, v in _flatten(tree):
            key = _port_key(coll, path, fused_initial, bottlenecks)
            t = torch.from_numpy(np.array(v))   # an owned copy
            if path[-1] == 'kernel' and not _is_filter(path):
                # HWIO -> OIHW (DHWIO -> OIDHW, WIO -> OIW, [in, out] -> [out,
                # in] for a Dense), in torch: a threaded copy, where numpy's is not
                n = t.dim()
                t = (t.permute(n - 1, n - 2, *range(n - 2)) if n >= 3 else t.t()).contiguous()
            out[key] = t
    return out


def detect_encoder_layout(state_dict) -> Tuple[str, bool]:
    """Infer ``(encoder, fused_initial)`` from torch-layout keys.

    Only a numbered body's keys tell: a ResNet's blocks carry ``conv1``/``bn1``
    (a ``ResBlock`` U-Net's carry ``downsample`` but no ``conv1``); a fused
    stem puts layer1 at ``body.0.4`` while the reference's UNet/FPN default
    (``fused_initial=False``) puts it under ``body.1.1``. A named body (the
    later families) reads as ``('unet', False)``, which its keys ignore.
    """
    body = [re.sub(r'^(core\.)?backbone\.body\.', '', k) for k in state_dict
            if re.match(r'(core\.)?backbone\.body\.\d', k)]
    encoder = 'resnet' if any('.conv1.' in k or '.bn1.' in k for k in body) else 'unet'
    fused = any(k.startswith('0.4.') for k in body)
    return encoder, fused


def body_layout(model) -> Tuple[str, bool]:
    """``(encoder, fused_initial)`` of a port CPN's backbone body: a ResNet
    body's layout, ``('unet', False)`` for every other."""
    from ..models.resnet import ResNetEncoder   # the models import this package
    body = getattr(model.core.backbone, 'body', None)
    if isinstance(body, ResNetEncoder):
        return 'resnet', bool(body.fused_initial)
    return 'unet', False


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
        t = torch.as_tensor(t).detach()
        coll, path, is_kernel = _jax_path(key, encoder, fused_initial, t.dim())
        # OIHW -> HWIO (OIDHW -> DHWIO, OIW -> WIO, [out, in] -> [in, out]), on the tensor's device
        if is_kernel:
            t = t.permute(*range(2, t.dim()), 1, 0) if t.dim() >= 3 else t.t()
        _set_path(variables.setdefault(coll, {}), path, t.contiguous().cpu().numpy())
    return variables


def init_jax_variables(model: torch.nn.Module, seed: int = 0) -> dict:
    """Seeded random weights for ``model`` as JAX-layout variables (numpy, fp32).

    Kernels are He-uniform (``sqrt(6 / fan_in)``), which keeps activation
    scale through ReLU stacks; biases and BatchNorm statistics are small
    perturbations around the identity. Leaves that start near zero and so
    hide a branch behind the identity get values of weight: ConvNeXt's
    ``layer_scale`` ``U(0.05, 0.15)``, GRN's ``gamma`` and ``beta`` and the
    PAB's ``beta`` ``U(0.25, 0.75)``. ``state_dict_from_jax`` of the result
    loads into ``model`` with ``strict=True`` (given the ``fused_initial`` of
    a ResNet body, which this function reads from ``model``).
    """
    encoder, fused_initial = body_layout(model)
    rng = np.random.RandomState(seed)
    variables = {}
    for key, t in model.state_dict().items():
        coll, path, is_kernel = _jax_path(key, encoder, fused_initial, t.dim())
        shape = tuple(t.shape)
        if is_kernel:
            o, i = shape[:2]
            bound = np.sqrt(6.0 / (i * int(np.prod(shape[2:], dtype=np.int64))))
            hwio = shape[2:] + (i, o) if len(shape) >= 3 else (i, o)
            v = rng.uniform(-bound, bound, hwio)
        elif path[-1] == 'A_log':   # a Mamba's state decay: flax's init, perturbed
            v = np.log(np.arange(1, shape[1] + 1)) + 0.1 * rng.randn(*shape)
        elif path[-1] == 'D':
            v = rng.uniform(0.5, 1.5, shape)
        elif path[-1] in ('scale', 'var'):
            v = rng.uniform(0.5, 1.5, shape)
        elif path[-1] == 'layer_scale':
            v = rng.uniform(0.05, 0.15, shape)
        elif path[-1] in ('gamma', 'beta'):
            v = rng.uniform(0.25, 0.75, shape)
        else:   # conv and norm biases, running means
            v = 0.1 * rng.randn(*shape)
        _set_path(variables.setdefault(coll, {}), path, v.astype(np.float32))
    return variables
