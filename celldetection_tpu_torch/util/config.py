"""Configs: ``Config``, ``Schedule``, ``conf2tweaks_`` and ``{'Name': {kwargs}}`` → objects.

Counterpart of ``celldetection_tpu/util/config.py``: ``conf2call`` (19-35),
``conf2optimizer`` with its registry (38-77), ``conf2scheduler`` (80-104),
``conf2tweaks_`` (107-148), ``Config`` (151-216) and ``Schedule``
(228-283). ``Config`` writes json (yaml, imported on use) and hashes its
contents as the JAX package does, so one config has one ``hash()`` in both.
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
import hashlib
import inspect
import json
import math
from collections import OrderedDict
from functools import partial
from itertools import product
from typing import Any, Callable, Dict, Union

import numpy as np
import torch

from .. import optim

__all__ = ['Config', 'Schedule', 'conf2call', 'conf2optimizer', 'conf2scheduler',
           'conf2tweaks_']


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


def conf2tweaks_(settings: dict, model):
    """Apply layer tweaks to a CPN model in place, e.g.
    ``conf2tweaks_({'BatchNorm2d': dict(momentum=0.05)}, model)``.

    Targets ``BatchNorm2d`` / ``BatchNorm3d`` / ``BatchNorm`` take
    ``momentum`` (torch's convention, the weight of the new batch) and
    ``eps``; every batch norm of the model gets them, explicit constructor
    values included. The port's norms keep flax's running statistics
    (``new = m * old + (1 - m) * batch``), so a torch momentum ``t`` becomes
    ``m = 1 - t`` there, as the JAX package converts it. The modules change
    in place, so a trainer or a tiled inference built before the tweak sees
    it at its next step. ``model.tweaks`` holds the overrides in the JAX
    package's form (``{'batchnorm': {'momentum': m, 'epsilon': e}}``).
    Another target or attribute raises.
    """
    from ..models.commons import Norm     # the models import this package
    tweaks = dict(getattr(model, 'tweaks', None) or {})
    for target, kwargs in (settings or {}).items():
        name = target if isinstance(target, str) else getattr(target, '__name__', str(target))
        if not name.lower().replace('_', '').startswith('batchnorm'):
            raise ValueError(f'Unsupported tweak target: {target!r}')
        ov = dict(tweaks.get('batchnorm', {}))
        for k, v in kwargs.items():
            if k == 'momentum':
                ov['momentum'] = 1. - float(v)        # torch -> flax convention
            elif k in ('eps', 'epsilon'):
                ov['epsilon'] = float(v)
            else:
                raise ValueError(f'Unsupported BatchNorm tweak: {k!r}')
        tweaks['batchnorm'] = ov
    ov = tweaks.get('batchnorm', {})
    for m in model.modules():
        if isinstance(m, Norm) and m.kind.startswith('batchnorm'):
            m.momentum = ov.get('momentum', m.momentum)
            m.eps = ov.get('epsilon', m.eps)
    model.tweaks = tweaks
    return model


class Config(dict):
    """Attribute-style config dict with json/yaml IO, hashing and argument binding.

    Examples:
        >>> conf = Config(model='CpnU22', optimizer={'Adam': {'lr': 1e-3}})
        >>> conf.model
        'CpnU22'
    """

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.__dict__ = self

    @staticmethod
    def from_json(filename) -> 'Config':
        c = Config()
        c.load_json(filename)
        return c

    @staticmethod
    def from_yaml(filename) -> 'Config':
        c = Config()
        c.load_yaml(filename)
        return c

    def load_json(self, filename):
        with open(filename) as f:
            self.update(json.load(f))

    def to_json(self, filename):
        with open(filename, 'w') as f:
            json.dump(self.to_dict(), f, indent=2, default=_json_default)

    def load_yaml(self, filename):
        import yaml
        with open(filename) as f:
            self.update(yaml.safe_load(f))

    def to_yaml(self, filename):
        import yaml
        with open(filename, 'w') as f:
            yaml.safe_dump(json.loads(json.dumps(self.to_dict(), default=_json_default)), f)

    def to_dict(self) -> dict:
        """The entries (nested Configs as dicts), without those whose key starts with ``_``."""
        return {k: (v.to_dict() if isinstance(v, Config) else v) for k, v in self.items()
                if not k.startswith('_')}

    def hash(self) -> str:
        """md5 of the sorted json of :meth:`to_dict` (the JAX package's hash)."""
        return hashlib.md5(json.dumps(self.to_dict(), sort_keys=True,
                                      default=_json_default).encode()).hexdigest()

    def args(self, fn: Callable) -> tuple:
        """Positional args of ``fn`` bound from config entries."""
        return tuple(self[n] for n in inspect.signature(fn).parameters if n in self)

    def kwargs(self, fn: Callable) -> dict:
        """Keyword args of ``fn`` bound from config entries."""
        return {n: self[n] for n in inspect.signature(fn).parameters if n in self}

    def __str__(self):
        return json.dumps(self.to_dict(), indent=2, default=_json_default)


def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


class Schedule:
    """Cross-product hyperparameter schedule with conditional settings.

    Examples:
        >>> s = Schedule(lr=(1e-3, 1e-4), batch_size=(8, 16))
        >>> len(s)
        4
        >>> s.add(momentum=(0.9,), conditions={'lr': 1e-3})
    """

    def __init__(self, **kwargs):
        self._settings: list = []
        self._conditions: list = []
        if kwargs:
            self.add(**kwargs)

    def add(self, conditions: Dict[str, Any] = None, **kwargs):
        """Add settings (each value a sequence of choices); with ``conditions``
        they apply only to the configs whose entries match."""
        norm = OrderedDict()
        for k, v in kwargs.items():
            if not isinstance(v, (tuple, list, set)):
                v = (v,)
            norm[k] = tuple(v)
        self._settings.append(norm)
        self._conditions.append(conditions)

    def _iter_configs(self):
        configs = [Config()]
        for settings, conditions in zip(self._settings, self._conditions):
            keys = list(settings.keys())
            new_configs = []
            for conf in configs:
                applies = conditions is None or all(
                    conf.get(k) == v or (isinstance(v, (tuple, list, set)) and conf.get(k) in v)
                    for k, v in conditions.items())
                if applies:
                    for values in product(*settings.values()):
                        c = Config(**conf)
                        c.update(dict(zip(keys, values)))
                        new_configs.append(c)
                else:
                    new_configs.append(conf)
            configs = new_configs
        seen = []
        for c in configs:
            if c not in seen:
                seen.append(c)
        return seen

    def __len__(self):
        return len(self._iter_configs())

    def __iter__(self):
        return iter(self._iter_configs())

    def __getitem__(self, item) -> Config:
        return self._iter_configs()[item]
