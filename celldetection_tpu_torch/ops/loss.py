"""Losses (plain PyTorch, masked fixed-shape reductions).

Counterpart of ``celldetection_tpu/ops/loss.py`` (the whole file). Invalid
rows are not dropped: every function takes a validity ``mask`` and computes a
masked mean, so shapes stay fixed.

The formulas are the JAX package's, operation for operation, so values and
gradients agree, and a gradient is NaN in the port exactly where it is NaN
in JAX (a masked slot can hold a value whose ``log`` has an infinite
derivative; the zero cotangent of ``where`` times that is NaN in both).
Two primitives follow JAX's derivative at a tie, where PyTorch's differs
(and so do the box IoUs of :mod:`.boxes`): :func:`.commons.clip`
(``jnp.clip``: half the gradient at a bound) and ``_abs`` (``jnp.abs``:
slope 1 at 0).

Inside :func:`global_means` every mean is over the global batch, the union
of the ranks' batches, as the JAX package's means are under a data-parallel
``jit``: each rank all-reduces the (detached) denominator and returns its
local sum over the global denominator, times the world size, so that
``DistributedDataParallel``'s average of the ranks' gradients is the
gradient of the global mean.
"""
import math
from contextlib import contextmanager
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .boxes import pairwise_box_iou, pairwise_generalized_box_iou, remove_small_boxes_mask
from .commons import clip

__all__ = [
    'reduce_loss', 'masked_mean', 'log_margin_loss', 'margin_loss', 'iou_loss', 'box_npll_loss',
    'sigmoid_focal_loss', 'l1_loss', 'bce_with_logits', 'cross_entropy', 'r1_regularization',
    'add_to_loss_dict', 'reduce_loss_dict', 'SigmoidFocalLoss', 'IoULoss', 'BoxNpllLoss',
    'global_means',
]

_MEANS_GROUP = [None]    # the process group of global_means, None outside it


@contextmanager
def global_means(group):
    """Within the block, :func:`masked_mean` (and every loss's ``'mean'``
    reduction) divides by the denominator of the whole ``group``'s batch;
    None keeps the means local."""
    prev, _MEANS_GROUP[0] = _MEANS_GROUP[0], group
    try:
        yield
    finally:
        _MEANS_GROUP[0] = prev


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` whose derivative is 1 at 0, as ``jnp.abs``'s (``torch.abs``'s is 0)."""
    return torch.where(x >= 0, x, -x)


def add_to_loss_dict(d: dict, key: str, loss, weight=None):
    """Accumulate a loss term (NaN and infinities → 0, optionally weighted) under ``key``."""
    if loss is None:
        return
    loss = torch.nan_to_num(loss, nan=0., posinf=0., neginf=0.)
    if weight is not None:
        loss = loss * weight
    d[key] = loss if d.get(key) is None else d[key] + loss


def reduce_loss_dict(losses: dict, divisor, ignore_prefix: str = '_'):
    """Sum the entries not starting with ``ignore_prefix``, divided by ``divisor``."""
    total = sum(v for k, v in losses.items()
                if v is not None and not k.startswith(ignore_prefix))
    return total / divisor


def _loss_class(fn, name):
    """Callable-class spelling of a functional loss."""
    class _Loss:
        def __init__(self, **defaults):
            self.defaults = defaults

        def __call__(self, *args, **kwargs):
            return fn(*args, **{**self.defaults, **kwargs})

        def __repr__(self):
            return f'{name}({self.defaults})'
    _Loss.__name__ = _Loss.__qualname__ = name
    return _Loss


def r1_regularization(fn, params, inputs: torch.Tensor, gamma: float = 1.,
                      reduction: str = 'sum') -> torch.Tensor:
    """R1 gradient penalty ``gamma / 2 * ||d fn / d inputs||^2`` per batch item.

    Args:
        fn: ``fn(params, inputs) -> logits``.
        params: Passed to ``fn``.
        inputs: ``[n, ...]``; a leaf that requires grad is made from it.
        reduction: 'sum' or 'mean' over the non-batch dims.
    """
    x = inputs.detach().requires_grad_(True)
    g, = torch.autograd.grad(fn(params, x).sum(), x, create_graph=True)
    sq = g.square().reshape(g.shape[0], -1)
    per_item = sq.sum(-1) if reduction == 'sum' else sq.mean(-1)
    return gamma * 0.5 * per_item


def _expand_mask(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim())).expand(x.shape)


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor], eps: float = 1e-12) -> torch.Tensor:
    """Mean of ``x`` where ``mask`` is True (0 for an empty mask).

    ``mask`` broadcasts against ``x`` from the left: a per-row mask covers all
    trailing element dims.
    """
    group = _MEANS_GROUP[0]
    if group is not None:
        return _global_masked_mean(x, mask, eps, group)
    if mask is None:
        return x.mean()
    mask = _expand_mask(mask, x)
    denom = mask.sum().to(x.dtype)
    return torch.where(mask, x, 0.).sum() / torch.clamp(denom, min=eps)


def _global_masked_mean(x, mask, eps, group):
    """This rank's share of the global masked mean, scaled by the world size
    (see :func:`global_means`)."""
    if mask is None:
        local, count = x.sum(), torch.tensor(x.numel(), device=x.device)
    else:
        mask = _expand_mask(mask, x)
        local, count = torch.where(mask, x, 0.).sum(), mask.sum()
    count = count.detach().clone()
    dist.all_reduce(count, group=group)
    denom = count.to(x.dtype)
    if mask is not None:
        denom = torch.clamp(denom, min=eps)
    return local / denom * dist.get_world_size(group)


def reduce_loss(x: torch.Tensor, reduction: str, mask: Optional[torch.Tensor] = None):
    if reduction == 'none':
        return x
    if reduction == 'mean':
        return masked_mean(x, mask)
    if reduction == 'sum':
        if mask is not None:
            x = torch.where(_expand_mask(mask, x), x, 0.)
        return x.sum()
    raise ValueError(f'Unknown reduction: {reduction}')


def l1_loss(inputs: torch.Tensor, targets: torch.Tensor, reduction: str = 'mean',
            mask: Optional[torch.Tensor] = None):
    return reduce_loss(_abs(inputs - targets), reduction, mask)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor, reduction: str = 'mean',
                    mask: Optional[torch.Tensor] = None):
    """Binary cross entropy on logits: ``max(x, 0) - x t + log1p(exp(-|x|))``."""
    loss = clip(logits, 0.) - logits * targets + torch.log1p(torch.exp(-_abs(logits)))
    return reduce_loss(loss, reduction, mask)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, reduction: str = 'mean',
                  mask: Optional[torch.Tensor] = None):
    """Softmax cross entropy with integer targets over the last axis."""
    logp = F.log_softmax(logits, -1)
    loss = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return reduce_loss(loss, reduction, mask)


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = .25,
                       gamma: float = 2., reduction: str = 'mean',
                       mask: Optional[torch.Tensor] = None):
    """Focal loss (RetinaNet), as ``torchvision.ops.sigmoid_focal_loss``."""
    p = torch.sigmoid(logits)
    ce = clip(logits, 0.) - logits * targets + torch.log1p(torch.exp(-_abs(logits)))
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
        loss = alpha_t * loss
    return reduce_loss(loss, reduction, mask)


def log_margin_loss(inputs: torch.Tensor, targets: torch.Tensor, m_pos: float = .9, m_neg=None,
                    exponent: float = 1, reduction: str = 'mean', eps: float = 1e-6,
                    mask: Optional[torch.Tensor] = None):
    if m_neg is None:
        m_neg = 1 - m_pos
    pos = torch.relu(torch.log(m_pos / (inputs + eps))) ** exponent
    neg = torch.relu(torch.log((1 - m_neg) / (1 - inputs + eps))) ** exponent
    loss = targets * pos + (1 - targets) * neg
    return reduce_loss(loss, reduction, mask)


def margin_loss(inputs: torch.Tensor, targets: torch.Tensor, m_pos: float = .9, m_neg=None,
                exponent: float = 2, reduction: str = 'mean',
                mask: Optional[torch.Tensor] = None):
    if m_neg is None:
        m_neg = 1 - m_pos
    pos = torch.relu(m_pos - inputs) ** exponent
    neg = torch.relu(inputs - m_neg) ** exponent
    loss = targets * pos + (1 - targets) * neg
    return reduce_loss(loss, reduction, mask)


def iou_loss(boxes: torch.Tensor, boxes_targets: torch.Tensor, reduction: str = 'mean',
             generalized: bool = True, method: str = 'linear', min_size: Optional[float] = None,
             mask: Optional[torch.Tensor] = None, eps: float = 1e-8):
    """(G)IoU box loss; ``min_size`` leaves degenerate boxes out through the mask."""
    if min_size is not None:
        size_mask = remove_small_boxes_mask(boxes, min_size)
        mask = size_mask if mask is None else (mask & size_mask)
    if generalized:
        iou = pairwise_generalized_box_iou(boxes, boxes_targets, eps=eps)
    else:
        iou = pairwise_box_iou(boxes, boxes_targets, eps=eps)
    if method == 'log':
        if generalized:
            iou = iou * .5 + .5
        loss = -torch.log(iou + 1e-8)
    elif method == 'linear':
        loss = 1 - iou
    else:
        raise ValueError(f'Unknown method: {method}')
    return reduce_loss(loss, reduction, mask)


def box_npll_loss(uncertainty: torch.Tensor, boxes: torch.Tensor, boxes_targets: torch.Tensor,
                  factor: float = 10., sigmoid: bool = False, epsilon: float = 1e-8,
                  reduction: str = 'mean', min_size: Optional[float] = None,
                  mask: Optional[torch.Tensor] = None):
    """Negative power log-likelihood box-uncertainty loss (arXiv:2006.15607).

    Args:
        uncertainty: ``[n, 4]`` uncertainties (sigmoid-activated unless
            ``sigmoid=True``).
        boxes, boxes_targets: ``[n, 4]``.
    """
    if min_size is not None:
        size_mask = remove_small_boxes_mask(boxes, min_size)
        mask = size_mask if mask is None else (mask & size_mask)
    delta_sq = ((torch.sigmoid(uncertainty) if sigmoid else uncertainty) * factor).square()
    a = (boxes - boxes_targets).square() / (2 * delta_sq + epsilon)
    b = 0.5 * torch.log(delta_sq + epsilon)
    iou = pairwise_box_iou(boxes, boxes_targets)
    loss = iou * ((a + b).sum(-1) + 2 * math.log(2 * math.pi))
    return reduce_loss(loss, reduction, mask)


SigmoidFocalLoss = _loss_class(sigmoid_focal_loss, 'SigmoidFocalLoss')
IoULoss = _loss_class(iou_loss, 'IoULoss')
BoxNpllLoss = _loss_class(box_npll_loss, 'BoxNpllLoss')
