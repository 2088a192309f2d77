"""Learning-rate schedules, the plateau controller and optax-exact optimizers.

Counterpart of ``celldetection_tpu/optim/__init__.py`` (``get_warmup_factor``,
``warmup_schedule``, ``sequential_schedule``, ``ReduceLROnPlateau``,
``resolve_rank_factor``, ``scaled_lr`` and the ``WarmUp``/``SequentialLR``
spellings). A schedule is a plain ``step -> lr multiplier`` function: the
trainer wraps it in ``torch.optim.lr_scheduler.LambdaLR``, whose first
update uses step 0, as ``optax.scale_by_schedule`` does.

:class:`RMSprop` and :class:`Adagrad` are the update rules of the JAX
package's optax optimizers where ``torch.optim``'s differ: optax's RMSprop
adds ``eps`` inside the square root, and its Adagrad does so too and leaves
an update with a zero accumulator at 0.
"""
from typing import Callable, Sequence

import numpy as np
import torch

__all__ = ['warmup_schedule', 'sequential_schedule', 'ReduceLROnPlateau', 'resolve_rank_factor',
           'scaled_lr', 'get_warmup_factor', 'WarmUp', 'SequentialLR', 'RMSprop', 'Adagrad']


def get_warmup_factor(step: int, steps: int = 1000, factor: float = 0.001,
                      method: str = 'linear') -> float:
    """Warmup multiplier at ``step``: ``factor`` rising to 1 over ``steps``."""
    if step >= steps:
        return 1.
    if method == 'constant':
        return factor
    if method == 'linear':
        a = step / steps
        return factor * (1 - a) + a
    raise ValueError(f'Unknown method: {method}')


def warmup_schedule(steps: int, base: float = 1.0) -> Callable[[int], float]:
    """Linear warmup multiplier: ``(step + 1) / steps`` up to ``base``."""
    def fn(step):
        return base * min((step + 1) / max(steps, 1), 1.0)
    return fn


def sequential_schedule(schedules: Sequence[Callable[[int], float]],
                        milestones: Sequence[int]) -> Callable[[int], float]:
    """Chain schedules at step milestones; each starts counting at 0 from its milestone."""
    milestones = list(milestones)
    starts = [0] + milestones

    def fn(step):
        i = int(np.searchsorted(milestones, step, side='right'))
        return float(schedules[i](step - starts[i]))
    return fn


class ReduceLROnPlateau:
    """Host-side plateau LR controller with a warmup grace period.

    Call ``factor = ctrl.step(metric)`` after each evaluation and multiply
    the LR by the returned cumulative factor.
    """

    def __init__(self, factor: float = 0.1, patience: int = 10, mode: str = 'min',
                 min_lr_factor: float = 1e-4, warmup_grace: int = 0, threshold: float = 1e-4):
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.min_lr_factor = min_lr_factor
        self.warmup_grace = warmup_grace
        self.threshold = threshold
        self.best = None
        self.bad_epochs = 0
        self.current = 1.0
        self._steps = 0

    def step(self, metric: float) -> float:
        self._steps += 1
        if self._steps <= self.warmup_grace:
            return self.current
        better = (self.best is None or
                  (self.mode == 'min' and metric < self.best - self.threshold) or
                  (self.mode == 'max' and metric > self.best + self.threshold))
        if better:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.current = max(self.current * self.factor, self.min_lr_factor)
                self.bad_epochs = 0
        return self.current


def resolve_rank_factor(factor, world_size: int) -> float:
    """LR scaling by world size: 'sqrt', 'linear' or a number."""
    if factor == 'sqrt':
        return float(np.sqrt(world_size))
    if factor == 'linear':
        return float(world_size)
    return float(factor)


def scaled_lr(lr: float, world_size: int, rank_factor='sqrt') -> float:
    return lr * resolve_rank_factor(rank_factor, world_size)


WarmUp = warmup_schedule
SequentialLR = sequential_schedule


class RMSprop(torch.optim.Optimizer):
    """optax's ``rmsprop``: ``nu = alpha nu + (1 - alpha) g^2``, ``u = g / sqrt(nu + eps)``,
    then the momentum trace ``t = u + momentum t`` when ``momentum``, and ``p -= lr u``.

    ``torch.optim.RMSprop`` divides by ``sqrt(nu) + eps`` instead.
    """

    def __init__(self, params, lr: float = 1e-2, alpha: float = 0.99, eps: float = 1e-8,
                 momentum: float = 0.):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps, momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            a, eps, mom = group['alpha'], group['eps'], group['momentum']
            for p in group['params']:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st['nu'] = torch.zeros_like(p)
                    if mom:
                        st['trace'] = torch.zeros_like(p)
                g = p.grad
                st['nu'] = (1 - a) * g.square() + a * st['nu']
                u = torch.rsqrt(st['nu'] + eps) * g
                if mom:
                    st['trace'] = u + mom * st['trace']
                    u = st['trace']
                p.add_(u, alpha=-group['lr'])
        return loss


class Adagrad(torch.optim.Optimizer):
    """optax's ``adagrad``: ``s += g^2``, ``u = g / sqrt(s + eps)`` where
    ``s > 0`` (else 0), ``p -= lr u``; the accumulator starts at
    ``initial_accumulator_value`` (0 as in torch).

    ``torch.optim.Adagrad`` divides by ``sqrt(s) + eps`` instead.
    """

    def __init__(self, params, lr: float = 1e-2, eps: float = 1e-10,
                 initial_accumulator_value: float = 0.):
        super().__init__(params, dict(lr=lr, eps=eps, initial=initial_accumulator_value))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            for p in group['params']:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st['sum'] = torch.full_like(p, group['initial'])
                g = p.grad
                st['sum'] = g.square() + st['sum']
                s = st['sum']
                scale = torch.where(s > 0, torch.rsqrt(s + group['eps']), 0.)
                p.add_(scale * g, alpha=-group['lr'])
        return loss
