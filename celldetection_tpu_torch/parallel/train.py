"""The training step, on one card or data-parallel over ranks.

Counterpart of ``celldetection_tpu/parallel/train.py``: ``mesh_spans_processes``
(20-32), ``TrainState`` (35-52) and ``make_train_step`` (55-131). The JAX
package's step over a mesh computes one program on the global batch: its
batch statistics and the denominators of its loss's means are global. Here a
mesh is a ``torch.distributed`` group of ranks, one card each: the model runs
in ``DistributedDataParallel``, its batch norms take the global batch's
statistics (:func:`..models.commons.set_norm_group_`) and its loss's means
the global denominators (:func:`..ops.loss.global_means`), so the step is
the one-process step on the union batch up to rounding.
"""
import inspect
from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..models.commons import set_norm_group_
from ..ops.loss import global_means
from .mesh import mesh_group

__all__ = ['TrainState', 'make_train_step', 'mesh_spans_processes']


def mesh_spans_processes(mesh) -> bool:
    """True when ``mesh`` (a ``DeviceMesh`` or process group) holds more than
    one rank: with one card per process, every mesh of two or more positions
    spans processes."""
    if mesh is None:
        return False
    return dist.get_world_size(mesh_group(mesh)) > 1


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


class _TrainForward(nn.Module):
    """``forward_padded`` in train mode as a module's ``forward``, which
    ``DistributedDataParallel`` wraps."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, image, targets, generator):
        return self.model.forward_padded(image, targets=targets, generator=generator)


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

    With a ``mesh`` (:func:`.mesh.make_mesh`, or a process group) every rank
    passes its process-local slice of the global batch. The model is wrapped
    in ``DistributedDataParallel`` over the mesh's group, which broadcasts
    rank 0's parameters once (and the step rank 0's buffers) and averages the
    gradients of every step; its norms and loss means cover the global batch, and the metrics
    are the global batch's, the same on every rank.
    """
    group = None
    forward = _TrainForward(model)
    if mesh is not None:
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError('make_train_step(mesh=...): no torch.distributed process group; '
                               'call parallel.initialize_distributed first')
        group = mesh_group(mesh)
        set_norm_group_(model, group)
        # the norms' running statistics are the global batch's on every rank
        # already: rank 0's buffers once, and no buffer sync before each
        # forward (newer torch names that option forward_sync_buffers)
        ddp = nn.parallel.DistributedDataParallel
        no_sync = ('forward_sync_buffers' if 'forward_sync_buffers' in
                   inspect.signature(ddp).parameters else 'broadcast_buffers')
        forward = ddp(forward, process_group=group, **{no_sync: False})
        src = dist.get_global_rank(group, 0) if group is not None else 0
        for b in model.buffers():
            dist.broadcast(b, src, group=group)

    def step_fn(state: TrainState, batch: dict, generator: Optional[torch.Generator] = None):
        model.train()
        batch = _to_device(batch, next(model.parameters()).device)
        image = batch.pop('image')
        with global_means(group):
            out = forward(image, batch, generator)
        optimizer.zero_grad(set_to_none=True)
        (out['loss'] * loss_scale).backward()
        if loss_scale != 1.0:
            for g in optimizer.param_groups:
                for p in g['params']:
                    if p.grad is not None:
                        p.grad.div_(loss_scale)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        state.step += 1
        terms = [k for k, v in out['losses'].items() if v is not None]
        values = torch.stack([out['loss'].detach()] + [out['losses'][k].detach() for k in terms])
        if group is not None:
            # each rank's loss is its share times the world size: their mean
            # is the global batch's loss
            dist.all_reduce(values, group=group)
            values = values / dist.get_world_size(group)
        metrics = {'loss': values[0], **{f'loss_{k}': values[i + 1] for i, k in enumerate(terms)}}
        return state, metrics

    return step_fn
