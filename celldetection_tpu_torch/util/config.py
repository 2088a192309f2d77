"""Optimizer and schedule configs: ``{'Name': {kwargs}}`` → objects.

Counterpart of ``celldetection_tpu/util/config.py``: ``conf2call`` (19-35),
``conf2optimizer`` with its registry (38-77) and ``conf2scheduler`` (80-104).
The names and defaults are torch's, the update rules the JAX package's:

* ``Adam``: ``weight_decay`` is an L2 term added to the gradient (torch's
  Adam; not AdamW);
* ``AdamW``, ``SGD``, ``Adamax``, ``Adadelta``: ``torch.optim``'s, whose
  rules equal optax's;
* ``RMSprop``, ``Adagrad``: :mod:`..optim`'s, with optax's ``eps`` inside
  the square root; Adagrad's accumulator starts at 0 and ``lr_decay``
  raises.

Unknown keyword arguments are ignored, as in the JAX registry.
"""
import math
from functools import partial
from typing import Callable, Union

import torch

from .. import optim

__all__ = ['conf2call', 'conf2optimizer', 'conf2scheduler']


def conf2call(settings: Union[dict, str], origin, **kwargs):
    """Resolve ``{'Name': {kwargs}}`` or ``'Name'`` to ``origin.Name(**kwargs)``.

    ``origin`` may be a module, an object or a dict of callables.
    """
    if not (isinstance(settings, str) or len(settings) == 1):
        raise ValueError(f'a config names exactly one callable: {settings}')
    if isinstance(settings, str):
        name, extra = settings, {}
    else:
        name, = settings.keys()
        extra = dict(settings[name]) if settings[name] else {}
    fn = origin[name] if isinstance(origin, dict) else getattr(origin, name)
    extra.update(kwargs)
    return fn(**extra)


def _adagrad(lr=1e-2, eps=1e-10, initial_accumulator_value=0., lr_decay=0., **kw):
    if lr_decay:
        raise ValueError('Adagrad lr_decay is not supported (the JAX package rejects it)')
    return partial(optim.Adagrad, lr=lr, eps=eps,
                   initial_accumulator_value=initial_accumulator_value)


_OPTIMIZERS = {
    'Adam': lambda lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0., **kw:
        partial(torch.optim.Adam, lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay),
    'AdamW': lambda lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2, **kw:
        partial(torch.optim.AdamW, lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay),
    'SGD': lambda lr=1e-2, momentum=0., nesterov=False, weight_decay=0., **kw:
        partial(torch.optim.SGD, lr=lr, momentum=momentum, nesterov=nesterov,
                weight_decay=weight_decay),
    'RMSprop': lambda lr=1e-2, alpha=0.99, eps=1e-8, momentum=0., **kw:
        partial(optim.RMSprop, lr=lr, alpha=alpha, eps=eps, momentum=momentum),
    'Adamax': lambda lr=2e-3, betas=(0.9, 0.999), eps=1e-8, **kw:
        partial(torch.optim.Adamax, lr=lr, betas=tuple(betas), eps=eps),
    'Adadelta': lambda lr=1., rho=0.9, eps=1e-6, weight_decay=0., **kw:
        partial(torch.optim.Adadelta, lr=lr, rho=rho, eps=eps, weight_decay=weight_decay),
    'Adagrad': _adagrad,
}


def conf2optimizer(settings: Union[dict, str]) -> Callable[..., torch.optim.Optimizer]:
    """Optimizer config → a factory ``params -> torch.optim.Optimizer``."""
    return conf2call(settings, _OPTIMIZERS)


def _warmup_cosine(warmup_steps, total_steps, base=1., eta_min=0., **kw):
    def fn(step):
        if step < warmup_steps:
            return base * (step + 1) / max(warmup_steps, 1)
        t = min(max(step - warmup_steps, 0), total_steps - warmup_steps)
        return eta_min + (base - eta_min) * 0.5 * (
            1 + math.cos(math.pi * t / max(total_steps - warmup_steps, 1)))
    return fn


_SCHEDULES = {
    'StepLR': lambda step_size, gamma=0.1, base=1., **kw:
        (lambda step: base * gamma ** (step // step_size)),
    'ExponentialLR': lambda gamma, base=1., **kw: (lambda step: base * gamma ** step),
    'CosineAnnealingLR': lambda T_max, eta_min=0., base=1., **kw:
        (lambda step: eta_min + (base - eta_min) * 0.5 *
         (1 + math.cos(math.pi * min(step, T_max) / T_max))),
    'WarmupCosine': _warmup_cosine,
}


def conf2scheduler(settings: Union[dict, str]) -> Callable[[int], float]:
    """Schedule config → ``step -> lr multiplier`` (step 0 is the first update)."""
    return conf2call(settings, _SCHEDULES)
