"""Box math and exact greedy NMS (plain PyTorch).

Counterpart of ``celldetection_tpu/ops/boxes.py``: ``box_area`` (79),
``box_iou`` (83-92), ``_pairwise_inter_union``, ``pairwise_box_iou`` and
``pairwise_generalized_box_iou`` (112-137), ``remove_small_boxes_mask``
(140-144), ``nms_padded`` (147-191), ``nms_chunked`` (253-347),
``nms_indices`` (350-362), ``get_iou_voting`` and ``filter_by_box_voting``
(365-387), and the reference's conveniences ``nms`` (30) and
``batched_box_nmsi`` (46) over ``nms_indices`` and ``nms_chunked``.
``_suppression_matrix`` (95-109) and ``_nms_sweep`` (216-250) live in
:mod:`..kernels.nms`, beside the hand-written CUDA kernels whose plain
versions they are: ``nms_padded`` on CPU tensors runs ``_nms_sweep``, the
oracle the kernels are held against.

Unlike the JAX package ``nms_padded`` has no size gate: on a CUDA tensor the
kernels run for every N up to ``kernels.nms.MAX_BOXES`` per image; on a CPU
tensor the plain sweep runs. ``nms_chunked`` takes the branches that the JAX
package takes on a TPU, on either device.
"""

import torch

from ..kernels import LAUNCHES, nms as kernel_nms
from ..util.spans import span

__all__ = ['box_area', 'box_iou', 'pairwise_box_iou', 'pairwise_generalized_box_iou',
           'sort_by_score', 'nms_padded', 'nms_chunked', 'nms_indices',
           'remove_small_boxes_mask', 'get_iou_voting', 'filter_by_box_voting',
           'EXACT_NMS_MIN', 'EXACT_NMS_MAX', 'nms', 'batched_box_nmsi']

# nms_chunked's exact branch: above its chunk, an image of EXACT_NMS_MIN to
# EXACT_NMS_MAX boxes takes nms_padded whole, as the JAX package does on a TPU
# (ops/boxes.py:_use_pallas_sweep there, _PALLAS_NMS_MIN and _PALLAS_NMS_MAX);
# larger ones take the chunked approximation. A test may lower them.
EXACT_NMS_MIN = 2048
EXACT_NMS_MAX = 262_144


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Full IoU matrix ``[n, m]`` of two box sets (0 where the union is not positive)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[:, None] + area2[None, :] - inter
    return torch.where(union > 0, inter / union, 0.)


def _pairwise_inter_union(boxes1: torch.Tensor, boxes2: torch.Tensor):
    # clipped with maximum, whose derivative splits at a tie as jnp.clip's does
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = torch.maximum(rb - lt, lt.new_zeros(()))
    inter = wh[..., 0] * wh[..., 1]
    return inter, area1 + area2 - inter


def pairwise_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 0.) -> torch.Tensor:
    """Aligned (element-wise) IoU of two equal-length box sets ``[..., 4]``."""
    inter, union = _pairwise_inter_union(boxes1, boxes2)
    iou = inter / (union + eps)
    return torch.where(iou >= 0, iou, -iou)   # |iou| with jnp.abs's slope 1 at 0


def pairwise_generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor,
                                 eps: float = 0.) -> torch.Tensor:
    """Aligned generalized IoU of two equal-length box sets ``[..., 4]``."""
    inter, union = _pairwise_inter_union(boxes1, boxes2)
    iou = inter / (union + eps)
    lti = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rbi = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    whi = torch.maximum(rbi - lti, lti.new_zeros(()))
    areai = whi[..., 0] * whi[..., 1]
    return iou - (areai - union) / (areai + eps)


def remove_small_boxes_mask(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    """Bool mask of boxes with both sides >= ``min_size``."""
    ws = boxes[..., 2] - boxes[..., 0]
    hs = boxes[..., 3] - boxes[..., 1]
    return (ws >= min_size) & (hs >= min_size)


def sort_by_score(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor):
    """The greedy visit order of ``[B, N]`` boxes and the boxes in that order.

    A stable descending sort of ``where(valid, scores, -inf)``: ties keep the
    lower index first, as JAX's stable descending argsort.

    Returns:
        ``(order [B, N], boxes [B, N, 4], valid [B, N])``, the last two sorted.
    """
    neg = torch.full_like(scores, -torch.inf)
    order = torch.sort(torch.where(valid, scores, neg), dim=1, descending=True,
                       stable=True).indices
    b = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    return order, b, torch.gather(valid, 1, order)


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
               iou_threshold: float, sweep=None) -> torch.Tensor:
    """Exact greedy NMS on capacity-padded boxes.

    Boxes are visited in descending score order (stable: the lower index
    first on ties, as JAX's stable descending argsort); a box is kept iff its
    IoU with every kept higher-scoring box is <= ``iou_threshold``.

    Args:
        boxes: ``[N, 4]`` or ``[B, N, 4]`` (x0, y0, x1, y1).
        scores: ``[N]`` or ``[B, N]``.
        valid: ``[N]`` or ``[B, N]`` bool; padded entries False.
        sweep: The sweep over score-sorted boxes: ``kernels.nms.nms_sweep``
            (the kernels on a CUDA tensor), looked up at each call, by
            default; ``kernels.nms._nms_sweep`` is its plain version on any
            device, which checks on the card pass.

    Returns:
        Bool keep mask of ``valid``'s shape in the original box order. On a
        CUDA tensor all images go through one call of the CUDA sweep.
    """
    if boxes.dim() == 2:
        return nms_padded(boxes[None], scores[None], valid[None], iou_threshold, sweep)[0]
    if valid.shape[1] == 0:
        return valid.clone()
    order, b, v = sort_by_score(boxes, scores, valid)
    keep_sorted = (sweep or kernel_nms.nms_sweep)(b, v, iou_threshold)
    return torch.zeros_like(valid).scatter_(1, order, keep_sorted) & valid


def _traced(trace, name: str, shape, device, fn):
    """``fn()``; where ``trace`` is a list, also the span ``nms.<name>`` (count
    ``m``; its kernels' ``nms.*`` spans count their launches), ended by a
    device synchronisation, and an entry in ``trace``: the pass's name,
    ``B x M``, host ms (the span's) and kernel launches (those added to
    ``kernels.LAUNCHES`` in the pass)."""
    if trace is None:
        return fn()

    def sync():
        if device.type == 'cuda':
            torch.cuda.synchronize(device)

    sync()
    before = sum(LAUNCHES.values())
    with span(f'nms.{name}', m=int(shape[1])) as sp:
        out = fn()
        sync()
        launches = sum(LAUNCHES.values()) - before
    trace.append(dict(name=name, batch=int(shape[0]), m=int(shape[1]), ms=sp.ms,
                      launches=launches))
    return out


def nms_chunked(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                iou_threshold: float, chunk: int = 16384, tile: int = 256,
                survivors_cap: int = None, return_overflow: bool = False, trace: list = None,
                sweep=None):
    """Greedy NMS for very large N (the cross-tile stitch), with the JAX package's branches on a TPU.

    * ``n <= chunk``: :func:`nms_padded`;
    * ``EXACT_NMS_MIN <= n <= EXACT_NMS_MAX``: :func:`nms_padded`, exact;
    * above: sort all boxes by score (stable, descending), cut them into
      score-contiguous chunks of ``chunk`` rows (rounded up to ``tile``, as
      the JAX package rounds it), sweep every chunk exactly in one batched
      :func:`..kernels.nms.nms_sweep`, then sweep the chunks' survivors, in
      score order, across the chunk borders. A box suppressed inside its
      chunk is not rescued when its suppressor loses the final pass: the
      approximation the JAX package makes.

    The cross-chunk pass holds ``survivors_cap`` rows (default ``4 * chunk``,
    at most ``n``, rounded up to ``tile``). It sweeps only the survivors: their
    count is read on the host once and the first ``min(count, cap)`` rows of
    the survivor order are swept; the rows past the count, which the JAX
    package carries as invalid, neither suppress nor are kept, so the keep
    set is the same.

    Args:
        boxes / scores / valid: ``[N, 4]``, ``[N]``, ``[N]`` bool.
        return_overflow: Also return whether more than ``cap`` boxes survived
            their chunks (the lowest-scored survivors were dropped).
        trace: a list to which each NMS pass appends its name, ``B x M``,
            host ms (synchronised; the span ``nms.exact``, ``nms.per-chunk``
            or ``nms.cross-chunk``) and kernel launches, and the chunked
            branch its survivor count.
        sweep: as :func:`nms_padded`'s, for every pass.

    Returns:
        Bool keep mask ``[N]`` in the original order (and the overflow flag,
        a Python bool).
    """
    n = boxes.shape[0]
    if n <= chunk or EXACT_NMS_MIN <= n <= EXACT_NMS_MAX:
        keep = _traced(trace, 'exact', (1, n), boxes.device,
                       lambda: nms_padded(boxes, scores, valid, iou_threshold, sweep))
        return (keep, False) if return_overflow else keep
    sweep = sweep or kernel_nms.nms_sweep
    chunk += (-chunk) % tile
    cap = min(survivors_cap or 4 * chunk, n)
    cap += (-cap) % tile
    s = torch.where(valid, scores, -torch.inf)
    order = torch.sort(s, descending=True, stable=True).indices
    order_p = torch.cat([order, order.new_zeros((-n) % chunk)])
    b, sp, v = boxes[order_p], s[order_p], valid[order_p]
    v[n:] = False
    num_chunks = len(order_p) // chunk
    keep = _traced(trace, 'per-chunk', (num_chunks, chunk), boxes.device,
                   lambda: sweep(b.view(num_chunks, chunk, 4), v.view(num_chunks, chunk),
                                 iou_threshold).reshape(-1))
    count = int(keep.sum())
    if trace is not None:
        trace.append(dict(name='survivors', count=count, cap=cap))
    m = min(count, cap)
    surv = torch.sort(torch.where(keep, sp, -torch.inf), descending=True,
                      stable=True).indices[:m]
    skeep = _traced(trace, 'cross-chunk', (1, m), boxes.device,
                    lambda: sweep(b[surv][None], keep[surv][None], iou_threshold)[0])
    out = torch.zeros_like(valid)
    out[order_p[surv]] = skeep
    out &= valid
    return (out, count > cap) if return_overflow else out


def nms_indices(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                iou_threshold: float):
    """NMS returning score-sorted keep indices (padded) and their validity.

    Returns:
        ``(indices, keep_valid)``, both ``[N]``: positions in the input sorted
        by descending score of the kept boxes (stable), and which are kept.
    """
    keep = nms_padded(boxes, scores, valid, iou_threshold)
    order = torch.sort(torch.where(keep, scores, -torch.inf), descending=True,
                       stable=True).indices
    return order, keep[order]


def _on_device(x, device):
    """A tensor stays on its own device unless ``device`` names one; any other
    input goes to ``resolve_device(device)``: the card unless the caller asks
    for the CPU, never a silent CPU run."""
    if torch.is_tensor(x) and device is None:
        return x
    from ..util.device import resolve_device
    return torch.as_tensor(x, device=resolve_device(device))


def nms(boxes, scores, iou_threshold: float, device=None):
    """torchvision-style NMS: the kept boxes' indices, by descending score, as
    host numpy (the reference's ``cd.ops.nms``). Tensors run on their own
    device (a CUDA tensor takes the NMS kernels), other inputs on ``device``,
    ``cuda`` by default. :func:`nms_padded` keeps everything on the device."""
    boxes = _on_device(boxes, device)
    scores = _on_device(scores, device).to(boxes.device)
    valid = torch.ones(boxes.shape[0], dtype=torch.bool, device=boxes.device)
    order, keep = nms_indices(boxes, scores, valid, iou_threshold)
    order, keep = order.cpu().numpy(), keep.cpu().numpy()
    return order[keep]


def batched_box_nmsi(boxes, scores, iou_threshold: float, batch_size: int = None, device=None):
    """NMS of each of several lists of boxes (the reference's
    ``cd.ops.batched_box_nmsi``): each list through :func:`nms_chunked`
    (``batch_size`` its chunk), on its tensors' device or, for other inputs,
    on ``device`` (``cuda`` by default); its kept indices returned as host
    numpy in stable descending score order."""
    import numpy as np
    assert len(boxes) == len(scores)
    out = []
    for b, s in zip(boxes, scores):
        b = _on_device(b, device)
        s = _on_device(s, device).to(b.device)
        v = torch.ones(b.shape[0], dtype=torch.bool, device=b.device)
        kw = {'chunk': int(batch_size)} if batch_size else {}
        keep = nms_chunked(b, s, v, iou_threshold, **kw)
        idx = np.flatnonzero(keep.cpu().numpy())
        out.append(idx[np.argsort(-s.cpu().numpy()[idx], kind='stable')])
    return out


def get_iou_voting(boxes: torch.Tensor, thresh: float, valid: torch.Tensor = None) -> torch.Tensor:
    """Sum of IoUs > thresh against all (valid) boxes, including self."""
    iou = box_iou(boxes, boxes)
    iou = iou * (iou > thresh)
    if valid is not None:
        iou = iou * valid[None, :]
    return iou.sum(-1)


def filter_by_box_voting(boxes: torch.Tensor, thresh: float, min_vote: float,
                         valid: torch.Tensor = None, return_votes: bool = False):
    """Keep mask of boxes whose IoU-vote sum reaches ``min_vote``.

    A box votes for itself (vote 1.0) and every box overlapping it with
    IoU > ``thresh`` adds its IoU to the vote.
    """
    votes = get_iou_voting(boxes, thresh, valid)
    mask = votes >= min_vote
    if valid is not None:
        mask = mask & valid
    if return_votes:
        return mask, votes
    return mask
