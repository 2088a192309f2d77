"""Weights between the JAX package's variables and the port's state dict.

``state_dict_from_jax`` is the port's own copy of the ``encoder='unet'``
branch of ``celldetection_tpu/util/torch_import.py:export_torch_state_dict``
(lines 280-400): JAX variables, as nested dicts of numpy arrays
(``{'params': ..., 'batch_stats': ...}``), become the reference torch layout
(conv HWIO → OIHW; BatchNorm ``scale``/``bias``/``mean``/``var`` →
``weight``/``bias``/``running_mean``/``running_var``) under the keys the port's
modules carry, so ``load_state_dict(..., strict=True)`` takes it.
``init_jax_variables`` goes the other way, to make seeded random weights in
the JAX layout for a port model.
"""
import re
from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ['state_dict_from_jax', 'init_jax_variables']

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


def _port_key(coll: str, path: Tuple[str, ...]) -> str:
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
    elif p[:2] == ['backbone', 'body']:
        m = re.fullmatch(r'block(\d+)', p[2])
        if m:
            i = int(m.group(1))
            pool = '1.' if i > 0 else ''   # body.<i> = Sequential(pool, block) for i > 0
            return f'core.backbone.body.{i}.{pool}{_two_conv_suffix(coll, p[3:])}'
    raise KeyError(f'no port module for {coll}/{"/".join(path)} (not ported yet?)')


def _jax_path(key: str) -> Tuple[str, Tuple[str, ...], bool]:
    """The port's state-dict key → (collection, flax path, is conv kernel)."""
    def conv(prefix, leaf):
        return 'params', prefix + ('kernel' if leaf == 'weight' else 'bias',), leaf == 'weight'

    def two_conv(prefix, idx, leaf):
        block = ('block0', 'block0', None, 'block1', 'block1')[idx]
        if idx in (0, 3):
            return conv(prefix + (block, 'conv'), leaf)
        coll, name = _NORM_PATHS[leaf]
        return coll, prefix + (block, 'norm', 'norm', name), False

    m = re.fullmatch(r'core\.(\w+_head)\.block\.([014])\.(\w+)', key)
    if m:
        head, idx, leaf = m.groups()
        if idx == '1':
            coll, name = _NORM_PATHS[leaf]
            return coll, (head, 'norm', 'norm', name), False
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
    m = re.fullmatch(r'core\.backbone\.body\.(\d+)\.(1\.)?([0134])\.(\w+)', key)
    if m and (int(m.group(1)) > 0) == bool(m.group(2)):
        return two_conv(('backbone', 'body', f'block{m.group(1)}'), int(m.group(3)), m.group(4))
    raise KeyError(f'no JAX variable for port key {key}')


def state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """JAX CPN variables (nested dicts of arrays) → the port's state dict (CPU tensors)."""
    out = {}
    for coll, tree in variables.items():
        for path, v in _flatten(tree):
            v = np.asarray(v)
            key = _port_key(coll, path)
            if path[-1] == 'kernel':
                v = np.transpose(v, (3, 2, 0, 1))   # HWIO -> OIHW
            out[key] = torch.from_numpy(np.array(v))   # an owned, contiguous copy
    return out


def init_jax_variables(model: torch.nn.Module, seed: int = 0) -> dict:
    """Seeded random weights for ``model`` as JAX-layout variables (numpy, fp32).

    Conv kernels are He-uniform (``sqrt(6 / fan_in)``), which keeps activation
    scale through ReLU stacks; conv biases and BatchNorm statistics are small
    perturbations around the identity. ``state_dict_from_jax`` of the result
    loads into ``model`` with ``strict=True``.
    """
    rng = np.random.RandomState(seed)
    variables = {}
    for key, t in model.state_dict().items():
        coll, path, is_kernel = _jax_path(key)
        shape = tuple(t.shape)
        if is_kernel:
            o, i, kh, kw = shape
            bound = np.sqrt(6.0 / (i * kh * kw))
            v = rng.uniform(-bound, bound, (kh, kw, i, o))
        elif path[-1] in ('scale', 'var'):
            v = rng.uniform(0.5, 1.5, shape)
        else:   # conv and norm biases, running means
            v = 0.1 * rng.randn(*shape)
        node = variables.setdefault(coll, {})
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = v.astype(np.float32)
    return variables
