"""ImageNet encoder weights from torchvision-layout state dicts on local files.

Counterpart of ``celldetection_tpu/util/pretrained.py:40-307``:
``adapt_first_conv``, ``translate_torchvision_{resnet,densenet,convnext}``,
``resolve_pretrained_state`` and ``apply_pretrained_``. A translator turns a
torchvision state dict into the JAX package's flat ``{(collection, flax
path): array}`` (kernels HWIO, ``Dense`` kernels ``[in, out]``), equal to the
JAX package's key by key and value by value; ``apply_pretrained_`` maps each
leaf to the port's key (:func:`.weights._port_key`) and layout and copies it
into the model's encoder.

Nothing is downloaded. ``spec`` is a local ``.pth`` path or a mapping of
arrays; ``True`` or a URL resolves only through a file already in
torch.hub's cache (``<hub dir>/checkpoints/<file name>``), and without one
it raises, naming the URL.
"""
import os
import re
from typing import Dict, Tuple

import numpy as np
import torch

from .weights import _port_key, body_layout

__all__ = ['DEFAULT_MODEL_URLS', 'adapt_first_conv', 'translate_torchvision_resnet',
           'translate_torchvision_densenet', 'translate_torchvision_convnext',
           'resolve_pretrained_state', 'resolve_pretrained', 'apply_pretrained_']

# torchvision's ImageNet checkpoints (the reference's table)
DEFAULT_MODEL_URLS = {
    'ResNet18': 'https://download.pytorch.org/models/resnet18-f37072fd.pth',
    'ResNet34': 'https://download.pytorch.org/models/resnet34-b627a593.pth',
    'ResNet50': 'https://download.pytorch.org/models/resnet50-11ad3fa6.pth',
    'ResNet101': 'https://download.pytorch.org/models/resnet101-cd907fc2.pth',
    'ResNet152': 'https://download.pytorch.org/models/resnet152-f82ba261.pth',
    'ResNeXt50': 'https://download.pytorch.org/models/resnext50_32x4d-1a0047aa.pth',
    'ResNeXt101': 'https://download.pytorch.org/models/resnext101_32x8d-8ba56ff5.pth',
    'WideResNet50': 'https://download.pytorch.org/models/wide_resnet50_2-9ba9bcbe.pth',
    'WideResNet101': 'https://download.pytorch.org/models/wide_resnet101_2-d733dc28.pth',
    'DenseNet121': 'https://download.pytorch.org/models/densenet121-a639ec97.pth',
    'DenseNet161': 'https://download.pytorch.org/models/densenet161-8d451a50.pth',
    'DenseNet169': 'https://download.pytorch.org/models/densenet169-b2777c0a.pth',
    'DenseNet201': 'https://download.pytorch.org/models/densenet201-c1103571.pth',
    'ConvNeXtTiny': 'https://download.pytorch.org/models/convnext_tiny-983f1562.pth',
    'ConvNeXtSmall': 'https://download.pytorch.org/models/convnext_small-0c510722.pth',
    'ConvNeXtBase': 'https://download.pytorch.org/models/convnext_base-6075fbad.pth',
    'ConvNeXtLarge': 'https://download.pytorch.org/models/convnext_large-ea097f82.pth',
}

_BASE = ('backbone', 'body')
_NORM_LEAVES = {'weight': ('params', 'scale'), 'bias': ('params', 'bias'),
                'running_mean': ('batch_stats', 'mean'), 'running_var': ('batch_stats', 'var')}


def adapt_first_conv(kernel_oihw: np.ndarray, in_channels: int) -> np.ndarray:
    """Resample a first conv's input channels to ``in_channels`` by nearest
    neighbour, as the reference's ``F.interpolate(mode='nearest')``: channel
    ``i`` is source channel ``floor(i * C_src / C_dst)``."""
    src = kernel_oihw.shape[1]
    if src == in_channels:
        return kernel_oihw
    return kernel_oihw[:, np.floor(np.arange(in_channels) * src / in_channels).astype(int)]


def _hwio(v: np.ndarray) -> np.ndarray:
    return np.transpose(v, (2, 3, 1, 0))   # OIHW -> HWIO


def _emit_conv(out, path, leaf, v):
    if leaf == 'weight':
        out[('params', path + ('kernel',))] = _hwio(v)
    elif leaf == 'bias':
        out[('params', path + ('bias',))] = v
    else:
        raise KeyError(f'Unexpected conv leaf {leaf} at {path}')


def _emit_norm(out, path, leaf, v):
    if leaf == 'num_batches_tracked':
        return
    coll, name = _NORM_LEAVES[leaf]
    out[(coll, path + ('norm', name))] = v


def _resnet_stage(out, layer, rest, v):
    """``layer<N>.<i>.{conv<k>|bn<k>|downsample.{0,1}}.<leaf>``."""
    m = re.fullmatch(r'(\d+)\.(conv\d|bn\d|downsample\.[01])\.(\w+)', rest)
    if m is None:
        raise KeyError(f'Unrecognized ResNet key: {layer}.{rest}')
    path = _BASE + (layer, f'block{m.group(1)}')
    kind, leaf = m.group(2), m.group(3)
    if kind in ('downsample.0', 'downsample.1'):
        kind = 'downsample_conv' if kind.endswith('0') else 'downsample_norm'
    if kind.startswith(('conv', 'downsample_conv')):
        _emit_conv(out, path + (kind,), leaf, v)
    else:
        _emit_norm(out, path + (kind,), leaf, v)


def translate_torchvision_resnet(state_dict: Dict[str, np.ndarray],
                                 in_channels: int = 3) -> Dict[Tuple, np.ndarray]:
    """Torchvision ResNet (plain, grouped, wide) → flat ``{(collection, path): array}``;
    the classifier ``fc`` is dropped and ``conv1`` adapted to ``in_channels``."""
    out = {}
    for key, v in state_dict.items():
        v = np.asarray(v)
        if key.startswith('fc.'):
            continue
        if key.startswith('conv1.'):
            leaf = key.split('.', 1)[1]
            _emit_conv(out, _BASE + ('conv1',), leaf,
                       adapt_first_conv(v, in_channels) if leaf == 'weight' else v)
        elif key.startswith('bn1.'):
            _emit_norm(out, _BASE + ('bn1',), key.split('.', 1)[1], v)
        else:
            m = re.match(r'(layer\d+)\.(.*)', key)
            if not m:
                raise KeyError(f'Unrecognized torchvision key: {key}')
            _resnet_stage(out, m.group(1), m.group(2), v)
    return out


# the 2017 files name a dense layer's parts 'norm.1', 'conv.2', ...; torchvision remaps them
_LEGACY_DENSE = re.compile(r'^(.*denselayer\d+\.(?:norm|relu|conv))\.([12])\.'
                           r'(weight|bias|running_mean|running_var)$')


def translate_torchvision_densenet(state_dict: Dict[str, np.ndarray],
                                   in_channels: int = 3) -> Dict[Tuple, np.ndarray]:
    """Torchvision DenseNet → flat ``{(collection, path): array}``: the module
    names are torchvision's; the classifier is dropped and ``conv0`` adapted."""
    out = {}
    for key, v in state_dict.items():
        v = np.asarray(v)
        if key.startswith('classifier.'):
            continue
        key = key[len('features.'):] if key.startswith('features.') else key
        m = _LEGACY_DENSE.match(key)
        if m:
            key = f'{m.group(1)}{m.group(2)}.{m.group(3)}'
        *mods, leaf = key.split('.')
        if mods[-1].startswith('conv'):
            if mods == ['conv0'] and leaf == 'weight':
                v = adapt_first_conv(v, in_channels)
            _emit_conv(out, _BASE + tuple(mods), leaf, v)
        elif mods[-1].startswith('norm'):
            _emit_norm(out, _BASE + tuple(mods), leaf, v)
        else:
            raise KeyError(f'Unrecognized torchvision densenet key: {key}')
    return out


def translate_torchvision_convnext(state_dict: Dict[str, np.ndarray],
                                   in_channels: int = 3) -> Dict[Tuple, np.ndarray]:
    """Torchvision ConvNeXt → flat ``{(collection, path): array}``.

    torchvision's ``features`` hold stage ``i``'s blocks at ``2i + 1`` and its
    LayerNorm + 2x2 downsample at ``2i``; a block is ``block.{0 depthwise
    conv, 2 LayerNorm, 3 Linear 4C, 5 Linear C}`` and ``layer_scale``
    (``[C, 1, 1]``, flattened here). The Linear weights are transposed to
    ``Dense`` kernels; the stem conv is adapted to ``in_channels``.
    """
    out = {}

    def put(path, leaf, v):
        out[('params', _BASE + path + (leaf,))] = v

    for key, v in state_dict.items():
        v = np.asarray(v)
        if key.startswith('classifier.'):
            continue
        if not key.startswith('features.'):
            raise KeyError(f'Unrecognized torchvision convnext key: {key}')
        parts = key[len('features.'):].split('.')
        fi, leaf = int(parts[0]), parts[-1]
        if fi == 0:                   # stem: 0 conv, 1 LayerNorm
            if parts[1] == '0':
                put(('stem_conv',), 'kernel' if leaf == 'weight' else 'bias',
                    _hwio(adapt_first_conv(v, in_channels)) if leaf == 'weight' else v)
            else:
                put(('stem_norm',), 'scale' if leaf == 'weight' else 'bias', v)
        elif fi % 2 == 0:             # downsample: 0 LayerNorm, 1 conv
            if parts[1] == '0':
                put((f'down{fi // 2}_norm',), 'scale' if leaf == 'weight' else 'bias', v)
            else:
                put((f'down{fi // 2}_conv',), 'kernel' if leaf == 'weight' else 'bias',
                    _hwio(v) if leaf == 'weight' else v)
        else:                         # the blocks of stage fi // 2
            blk = (f'stage{fi // 2}_block{int(parts[1])}',)
            if parts[2] == 'layer_scale':
                put(blk, 'layer_scale', v.reshape(-1))
                continue
            idx = int(parts[3])
            if idx == 0:
                put(blk + ('dwconv',), 'kernel' if leaf == 'weight' else 'bias',
                    _hwio(v) if leaf == 'weight' else v)
            elif idx == 2:
                put(blk + ('norm',), 'scale' if leaf == 'weight' else 'bias', v)
            elif idx in (3, 5):
                put(blk + ('mlp0' if idx == 3 else 'mlp1',), 'kernel' if leaf == 'weight' else
                    'bias', v.T if leaf == 'weight' else v)
            else:
                raise KeyError(f'Unrecognized torchvision convnext key: {key}')
    return out


def _family_from_model_name(model_name: str):
    """'CpnResNeXt101UNet' → 'ResNeXt101' (the longest match), or a timm/smp
    encoder name of the native table ('resnet50', 'timm-resnext101_32x8d')."""
    for key in sorted(DEFAULT_MODEL_URLS, key=len, reverse=True):
        if key in model_name:
            return key
    from ..models.host_encoder import NATIVE_ENCODER_NAMES, normalize_encoder_name
    return NATIVE_ENCODER_NAMES.get(normalize_encoder_name(model_name))


def _hub_cached(url: str) -> str:
    """The file torch.hub would have downloaded ``url`` to, if it is there."""
    fn = os.path.join(torch.hub.get_dir(), 'checkpoints', os.path.basename(url))
    if not os.path.isfile(fn):
        raise FileNotFoundError(f'pretrained weights {url} are not in torch.hub\'s cache ({fn}) '
                                f'and nothing is downloaded: place the file there, or pass its '
                                f'local path as the pretrained spec')
    return fn


def resolve_pretrained_state(spec, model_name: str = '') -> Dict[str, np.ndarray]:
    """A ``pretrained`` spec → a torch-layout state dict of numpy arrays.

    ``spec``: a mapping of arrays, a local file, a URL (through torch.hub's
    cache only), or ``True`` (the URL of ``model_name``'s encoder).
    """
    if isinstance(spec, dict):
        return {k: np.asarray(v) for k, v in spec.items()}
    if spec is True:
        family = _family_from_model_name(model_name)
        if family is None or family not in DEFAULT_MODEL_URLS:
            raise ValueError(f'No pretrained weights known for {model_name!r}; '
                             f'available: {sorted(DEFAULT_MODEL_URLS)}')
        spec = DEFAULT_MODEL_URLS[family]
    if isinstance(spec, str) and spec.startswith(('http://', 'https://')):
        spec = _hub_cached(spec)
    if not (isinstance(spec, str) and os.path.isfile(spec)):
        raise ValueError(f'Cannot resolve pretrained spec: {spec!r}')
    data = torch.load(spec, map_location='cpu', weights_only=True)
    if 'state_dict' in data and not any(k.startswith(('conv1', 'layer')) for k in data):
        data = data['state_dict']
    return {k: v.numpy() if hasattr(v, 'numpy') else np.asarray(v) for k, v in data.items()}


resolve_pretrained = resolve_pretrained_state   # the reference's spelling


@torch.no_grad()
def apply_pretrained_(model, spec) -> None:
    """Load ImageNet weights into a port CPN's encoder (``core.backbone.body``), in place.

    The translator follows the model's name (``hparams['model']``, or
    ``hparams['model_name']`` for a Timm/Smp CPN) or the state dict's keys.
    Decoder and heads keep their init. Every encoder leaf must be covered
    (``KeyError``), and every translated leaf must exist in the model
    (``KeyError``) with its shape (``ValueError``).
    """
    hparams = getattr(model, 'hparams', {}) or {}
    model_name = hparams.get('model', '') or ''
    if spec is True and _family_from_model_name(model_name) is None:
        model_name = hparams.get('model_name', '') or model_name
    in_channels = hparams.get('in_channels', 3)
    sd = resolve_pretrained_state(spec, model_name)
    if 'DenseNet' in model_name or any(k.startswith(('features.denseblock', 'denseblock'))
                                       for k in sd):
        flat = translate_torchvision_densenet(sd, in_channels=in_channels)
    elif 'ConvNeXt' in model_name or any('.block.' in k for k in sd):
        flat = translate_torchvision_convnext(sd, in_channels=in_channels)
    else:
        flat = translate_torchvision_resnet(sd, in_channels=in_channels)
    _, fused = body_layout(model)
    target = model.state_dict()
    covered = set()
    for (coll, path), v in flat.items():
        try:
            key = _port_key(coll, path, fused)
        except KeyError:
            key = None
        where = f'{coll}/{"/".join(path)}'
        if key not in target:
            raise KeyError(f'Pretrained leaf not in model: {where}')
        t = torch.from_numpy(np.ascontiguousarray(v))
        if path[-1] == 'kernel':
            t = t.permute(3, 2, 0, 1) if t.dim() == 4 else t.t()
        if tuple(t.shape) != tuple(target[key].shape):
            raise ValueError(f'Pretrained shape mismatch at {where}: {tuple(t.shape)} vs the '
                             f'model\'s {tuple(target[key].shape)} (torch layout)')
        target[key].copy_(t)
        covered.add(key)
    missing = [k for k in target if k.startswith('core.backbone.body.') and k not in covered]
    if missing:
        raise KeyError(f'{len(missing)} encoder leaves not covered by pretrained weights, e.g. '
                       + ', '.join(missing[:8]))
