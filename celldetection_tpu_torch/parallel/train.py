"""The training step on one card.

Counterpart of ``celldetection_tpu/parallel/train.py``: ``TrainState``
(35-52) and ``make_train_step`` (55-131) without a mesh. The JAX package's
data-parallel step over a device mesh, and over several processes, maps to
``DistributedDataParallel``, which a later slice of the port brings; a mesh
raises here.
"""
from typing import Callable, Optional, Union

import numpy as np
import torch

__all__ = ['TrainState', 'make_train_step']

DDP_SLICE = ('data-parallel training over several cards (DistributedDataParallel) is not '
             'ported yet; it comes with the DDP slice of the port')


class TrainState:
    """What a training run carries: the model (its parameters and norm
    statistics live in it), the optimizer with its state, an optional
    learning-rate schedule and the number of steps taken."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None, step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.step = step

    @classmethod
    def create(cls, model: torch.nn.Module,
               tx: Union[torch.optim.Optimizer, Callable[..., torch.optim.Optimizer]],
               schedule: Optional[Callable[[int], float]] = None) -> 'TrainState':
        """``tx``: an optimizer over ``model``'s parameters, or a factory
        ``params -> optimizer`` (:func:`..util.config.conf2optimizer`).
        ``schedule``: ``step -> lr multiplier``, step 0 at the first update."""
        opt = tx if isinstance(tx, torch.optim.Optimizer) else tx(model.parameters())
        sched = None if schedule is None else torch.optim.lr_scheduler.LambdaLR(opt, schedule)
        return cls(model, opt, sched)

    def variables(self) -> dict:
        return self.model.state_dict()


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v)
            .to(device, non_blocking=True) for k, v in batch.items()}


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer, mesh=None,
                    loss_scale: float = 1.0, scheduler=None):
    """Build the CPN training step.

    Returns ``step_fn(state, batch, generator) -> (state, metrics)``: ``batch``
    holds ``image [B, H, W, C]`` and the target keys of
    :func:`..data.targets.collate_cpn_targets` (numpy or tensors), and
    ``generator`` is a ``torch.Generator`` on the model's device for the
    step's random draws. One forward in train mode with the loss, one
    backward, one optimizer step (and one schedule step). ``loss_scale``
    multiplies the loss before the backward and divides the gradients after
    it. ``metrics`` are 0-dim tensors on the device: ``loss`` and
    ``loss_<term>`` for each term.
    """
    if mesh is not None:
        raise NotImplementedError(DDP_SLICE)

    def step_fn(state: TrainState, batch: dict, generator: Optional[torch.Generator] = None):
        model.train()
        batch = _to_device(batch, next(model.parameters()).device)
        image = batch.pop('image')
        out = model.forward_padded(image, targets=batch, generator=generator)
        optimizer.zero_grad(set_to_none=True)
        (out['loss'] * loss_scale).backward()
        if loss_scale != 1.0:
            for group in optimizer.param_groups:
                for p in group['params']:
                    if p.grad is not None:
                        p.grad.div_(loss_scale)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        state.step += 1
        metrics = {'loss': out['loss'].detach(),
                   **{f'loss_{k}': v.detach() for k, v in out['losses'].items() if v is not None}}
        return state, metrics

    return step_fn
