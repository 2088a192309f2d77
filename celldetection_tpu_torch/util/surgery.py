"""Parameter surgery: select, map, replace, freeze, normalise and average parameters.

Counterpart of ``celldetection_tpu/util/surgery.py``. The JAX package works
on flax parameter trees with ``/``-joined paths; the port works on a module's
``named_parameters()`` (changed in place, the module returned) or on a state
dict (a new dict returned), with the dotted names of the reference torch
layout (``core.backbone.body.*``). A pattern is a regular expression searched
in each name.

The JAX package's default pattern, ``kernel$``, selects the kernels of
convolutions and dense layers. Its counterpart here, ``pattern=None``,
selects the ``weight`` s with two or more axes, the weights of convolutions
and linear layers, and not the norms' 1-D scales, which torch also names
``weight``. The spectral and weight norms see a weight in the JAX layout:
OIHW permuted to HWIO (``[out, in]`` to ``[in, out]``), then reshaped to
``[-1, out]``; the spectral norm's power iteration starts from a uniform
vector, as the JAX package's does (``torch.nn.utils.spectral_norm`` starts
from a random one).
"""
import re
from typing import Callable, Dict, Optional

import torch

__all__ = ['iter_params', 'match_paths', 'map_params', 'replace_params', 'freeze_mask',
           'frozen_optimizer', 'ema_update', 'count_params', 'spectral_normalize',
           'weight_normalize', 'spectral_norm_', 'weight_norm_',
           'exponential_moving_average_']


def _leaves(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _selects(pattern: Optional[str]) -> Callable[[str, torch.Tensor], bool]:
    if pattern is None:         # convolution and linear weights
        return lambda name, t: name.endswith('weight') and t.dim() >= 2
    rx = re.compile(pattern)
    return lambda name, t: rx.search(name) is not None


def iter_params(params, pattern: Optional[str] = '.*'):
    """Yield ``(name, tensor)`` for the parameters whose name matches ``pattern``."""
    sel = _selects(pattern)
    for name, t in _leaves(params).items():
        if sel(name, t):
            yield name, t


def match_paths(params, pattern: Optional[str]):
    """The set of names that match ``pattern``."""
    return {name for name, _ in iter_params(params, pattern)}


def _updated(params, new: Dict[str, torch.Tensor]):
    """``params`` with the entries of ``new``: a module's parameters are
    overwritten in place (the module is returned), a dict is copied."""
    if isinstance(params, torch.nn.Module):
        named = dict(params.named_parameters())
        with torch.no_grad():
            for name, v in new.items():
                named[name].copy_(v)
        return params
    out = dict(params)
    out.update(new)
    return out


def map_params(params, fn: Callable, pattern: Optional[str] = '.*'):
    """Apply ``fn(name, tensor) -> tensor`` to the matching parameters."""
    with torch.no_grad():
        new = {name: fn(name, t.detach()) for name, t in iter_params(params, pattern)}
    return _updated(params, new)


def replace_params(params, replacements: Dict[str, object]):
    """Replace parameters by name (strict: an unknown name raises ``KeyError``,
    another shape ``ValueError``); the values keep each parameter's dtype and device."""
    leaves = _leaves(params)
    new = {}
    for name, v in replacements.items():
        if name not in leaves:
            raise KeyError(f'No parameter at path: {name}')
        tgt = leaves[name]
        v = torch.as_tensor(v)
        if tuple(tgt.shape) != tuple(v.shape):
            raise ValueError(f'Shape mismatch at {name}: {tuple(v.shape)} vs {tuple(tgt.shape)}')
        new[name] = v.to(dtype=tgt.dtype, device=tgt.device)
    return _updated(params, new)


def freeze_mask(params, pattern: str, frozen: bool = True) -> Dict[str, bool]:
    """Name → trainable. ``pattern`` marks the frozen parameters (with
    ``frozen=False``, the trainable ones)."""
    rx = re.compile(pattern)
    return {name: (rx.search(name) is None) if frozen else (rx.search(name) is not None)
            for name in _leaves(params)}


def frozen_optimizer(optimizer, model: torch.nn.Module, pattern: str) -> torch.optim.Optimizer:
    """An optimizer over the parameters of ``model`` that ``pattern`` does not
    match; the matching ones get ``requires_grad=False`` and stay as they are.

    Args:
        optimizer: A factory ``params -> torch.optim.Optimizer`` (e.g.
            ``torch.optim.Adam`` or :func:`.config.conf2optimizer`'s), or a
            config such as ``{'Adam': {'lr': 1e-3}}``.
        model: The module.
        pattern: Regular expression of the frozen parameters' names.

    The optimizer's state holds the trainable parameters alone, as optax's
    ``masked`` holds its inner state for the unmasked leaves alone.
    """
    if isinstance(optimizer, (dict, str)):
        from .config import conf2optimizer
        optimizer = conf2optimizer(optimizer)
    trainable = freeze_mask(model, pattern, frozen=True)
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(trainable[name])
        if trainable[name]:
            params.append(p)
    return optimizer(params)


def _jax_layout(t: torch.Tensor) -> torch.Tensor:
    """A weight in the JAX package's layout: OIHW → HWIO, ``[out, in]`` → ``[in, out]``."""
    if t.dim() >= 2:
        return t.permute(*range(2, t.dim()), 1, 0)
    return t.reshape(1, -1)


def _torch_layout(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dim() >= 2:
        n = like.dim()
        return w.permute(n - 1, n - 2, *range(n - 2)).contiguous()
    return w.reshape(like.shape)


def spectral_normalize(params, pattern: Optional[str] = None, iterations: int = 20,
                       eps: float = 1e-12):
    """Divide each matching weight by its largest singular value, estimated by
    ``iterations`` steps of power iteration on the weight as a ``[-1, out]``
    matrix in the JAX layout, from a uniform vector."""

    def norm_one(name, v):
        hwio = _jax_layout(v)
        w = hwio.reshape(-1, hwio.shape[-1])
        u = torch.ones(w.shape[0], dtype=v.dtype, device=v.device) / (w.shape[0] ** 0.5)
        for _ in range(iterations):
            vv = w.T @ u
            vv = vv / (torch.linalg.norm(vv) + eps)
            u = w @ vv
            u = u / (torch.linalg.norm(u) + eps)
        sigma = u @ (w @ vv)
        return v / (sigma + eps)

    return map_params(params, norm_one, pattern)


def weight_normalize(params, pattern: Optional[str] = None, eps: float = 1e-12):
    """Scale each matching weight to unit L2 norm per output channel (the norm
    taken over every axis but the output axis)."""

    def norm_one(name, v):
        hwio = _jax_layout(v)
        n = torch.linalg.norm(hwio.reshape(-1, hwio.shape[-1]), dim=0)
        return _torch_layout(hwio / (n + eps), v)

    return map_params(params, norm_one, pattern)


def ema_update(ema_params, new_params, decay: float = 0.999):
    """Exponential moving average ``decay * ema + (1 - decay) * new``, entry by
    entry: of two modules' parameters (``ema_params`` updated in place and
    returned) or of two state dicts (a new dict)."""
    new = _leaves(new_params)
    with torch.no_grad():
        avg = {name: e.detach() * decay + new[name].detach() * (1. - decay)
               for name, e in _leaves(ema_params).items()}
    return _updated(ema_params, avg)


def count_params(params) -> int:
    """The number of elements of all parameters."""
    return sum(int(t.numel()) for t in _leaves(params).values())


# the reference's spellings
spectral_norm_ = spectral_normalize
weight_norm_ = weight_normalize
exponential_moving_average_ = ema_update
