"""Box math and exact greedy NMS (plain PyTorch).

Counterpart of ``celldetection_tpu/ops/boxes.py``: ``box_area`` (79),
``_suppression_matrix`` (95-109), ``nms_padded`` (147-191) and ``_nms_sweep``
(216-250). ``_nms_sweep`` is the plain version of the hand-written CUDA sweep
in :mod:`..kernels.nms`, and ``nms_padded`` on CPU tensors is the oracle the
kernel is held against.

Unlike the JAX package there is no size gate: on a CUDA tensor the kernel
runs for every N; on a CPU tensor the plain sweep runs.
"""
import torch

__all__ = ['box_area', 'sort_by_score', 'nms_padded']


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def _suppression_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor, thresh: float) -> torch.Tensor:
    """``IoU > thresh`` as ``inter > thresh * union``, ``[..., n, m]`` bool.

    The multiply form with ``union = (area1 + area2) - inter``, in that order,
    is the one the JAX sweep, the Pallas kernel and the CUDA kernel all use,
    so all of them round identically on knife-edge IoUs.
    """
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = (area1[..., :, None] + area2[..., None, :]) - inter
    return torch.where(union > 0, inter, 0.) > thresh * union


def _nms_sweep(b: torch.Tensor, v: torch.Tensor, iou_threshold: float,
               tile: int = 128) -> torch.Tensor:
    """Blocked greedy suppression sweep over score-descending boxes.

    Args:
        b: ``[B, M, 4]`` boxes, each row sorted by descending score.
        v: ``[B, M]`` bool validity.

    Returns:
        Keep mask ``[B, M]`` in the given (sorted) order.
    """
    bsz, m = v.shape
    pad = (-m) % tile
    if pad:
        b = torch.cat([b, b.new_zeros(bsz, pad, 4)], 1)
        v = torch.cat([v, v.new_zeros(bsz, pad)], 1)
    keep = v.clone()
    later_than = torch.ones(tile, tile, dtype=torch.bool, device=b.device).triu(1)
    for start in range(0, m + pad, tile):
        stop = start + tile
        rows = b[:, start:stop]
        k = keep[:, start:stop]
        sup_rr = _suppression_matrix(rows, rows, iou_threshold) & later_than
        for j in range(tile):  # sequential greedy inside the tile
            k = k & ~(sup_rr[:, j] & k[:, j:j + 1])
        keep[:, start:stop] = k
        if stop < m + pad:  # suppress strictly later boxes against kept rows
            sup = _suppression_matrix(rows, b[:, stop:], iou_threshold) & k[:, :, None]
            keep[:, stop:] &= ~sup.any(1)
    return keep[:, :m]


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
               iou_threshold: float) -> torch.Tensor:
    """Exact greedy NMS on capacity-padded boxes.

    Boxes are visited in descending score order (stable: the lower index
    first on ties, as JAX's stable descending argsort); a box is kept iff its
    IoU with every kept higher-scoring box is <= ``iou_threshold``.

    Args:
        boxes: ``[N, 4]`` or ``[B, N, 4]`` (x0, y0, x1, y1).
        scores: ``[N]`` or ``[B, N]``.
        valid: ``[N]`` or ``[B, N]`` bool; padded entries False.

    Returns:
        Bool keep mask of ``valid``'s shape in the original box order. On a
        CUDA tensor all images go through one launch of the CUDA sweep.
    """
    from ..kernels.nms import nms_sweep

    if boxes.dim() == 2:
        return nms_padded(boxes[None], scores[None], valid[None], iou_threshold)[0]
    if valid.shape[1] == 0:
        return valid.clone()
    order, b, v = sort_by_score(boxes, scores, valid)
    keep_sorted = nms_sweep(b, v, iou_threshold)
    return torch.zeros_like(valid).scatter_(1, order, keep_sorted) & valid
