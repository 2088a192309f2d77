"""CPN decode math (plain PyTorch, fixed shapes).

Counterpart of ``celldetection_tpu/ops/cpn.py``: ``rel_location2abs_location``
(35-60), ``fourier_basis`` and ``fouriers2contours`` (63-109), ``get_scale``,
``scale_contours`` and ``scale_fourier`` (112-136), ``order_weighting``
(139-146), ``refinement_bucket_weight`` and ``resolve_refinement_buckets``
(149-165), ``remove_border_contours``
and ``filter_contours_by_stitching_rule`` (167-226), ``batched_box_nms``
(229-237).
"""
import functools
import math
from typing import Optional

import torch

from .boxes import nms_padded

__all__ = ['rel_location2abs_location', 'fourier_basis', 'fouriers2contours', 'get_scale',
           'scale_contours', 'scale_fourier', 'order_weighting', 'refinement_bucket_weight',
           'resolve_refinement_buckets', 'remove_border_contours',
           'filter_contours_by_stitching_rule', 'batched_box_nms']


def rel_location2abs_location(locations: torch.Tensor, channels_last: bool = None) -> torch.Tensor:
    """Add the pixel-grid offset to relative xy locations.

    Args:
        locations: ``[..., 2, h, w]`` (channel-first) or ``[..., h, w, 2]``.
        channels_last: Layout; when None, channels-last iff the last axis has
            extent 2 (pass it explicitly for 2-row channel-first maps).
    """
    if channels_last is None:
        channels_last = locations.shape[-1] == 2
    h, w = (locations.shape[-3], locations.shape[-2]) if channels_last else locations.shape[-2:]
    kw = dict(dtype=locations.dtype, device=locations.device)
    gy, gx = torch.meshgrid(torch.arange(h, **kw), torch.arange(w, **kw), indexing='ij')
    return locations + torch.stack((gx, gy), -1 if channels_last else 0)


def fourier_basis(order: int, samples: int = None, sampling: torch.Tensor = None,
                  dtype=torch.float32, device=None):
    """Cos/sin basis ``(..., order, samples)`` of the inverse elliptic-Fourier transform.

    Returns ``(c_cos, c_sin, sampling)``. The default sampling is
    ``i * (1 / (samples - 1))`` in ``dtype``: bit for bit what
    ``jnp.linspace(0, 1, samples)`` gives, since XLA turns its divide into
    that multiply (``i / (samples - 1)`` differs in the last bit). The step
    is filled on the device, not copied from the host.
    """
    if sampling is None:
        if samples == 1:
            sampling = torch.zeros(1, dtype=dtype, device=device)
        else:
            step = torch.full((), 1. / (samples - 1), dtype=dtype, device=device)
            sampling = torch.arange(samples, dtype=dtype, device=device) * step
    k = torch.arange(1, order + 1, dtype=sampling.dtype, device=sampling.device)
    c = (2.0 * math.pi) * k[:, None] * sampling[..., None, :]
    return torch.cos(c), torch.sin(c), sampling


def fouriers2contours(fourier: torch.Tensor, locations: torch.Tensor, samples: int = 64,
                      sampling: Optional[torch.Tensor] = None):
    """Inverse-DFT sampling: Fourier descriptors → contour coordinates.

    ``con[..., s, :] = loc + sum_k [a,c]_k cos(2 pi k t_s) + [b,d]_k sin(2 pi k t_s)``

    The order contraction is a broadcast multiply and sum in the input dtype,
    not a matrix product, so no TF32 path can touch it. The x and y
    coefficients are strided views (a list index would be copied from the
    host).

    Args:
        fourier: ``[..., order, 4]`` coefficients (a, b, c, d).
        locations: ``[..., 2]`` contour centroids (x, y).
        samples: Number of contour samples (ignored if ``sampling`` given).
        sampling: Optional ``[..., samples]`` positions in [0, 1].

    Returns:
        ``(contours [..., samples, 2], sampling)``.
    """
    order = fourier.shape[-2]
    c_cos, c_sin, sampling = fourier_basis(order, samples, sampling, dtype=fourier.dtype,
                                           device=fourier.device)
    cos_coef = fourier[..., None, 0::2]     # [..., order, 1, 2]: a, c
    sin_coef = fourier[..., None, 1::2]     # b, d
    con = (cos_coef * c_cos[..., None]).sum(-3)          # [..., samples, 2]
    con = con + (sin_coef * c_sin[..., None]).sum(-3)
    return con + locations[..., None, :], sampling


@functools.lru_cache(maxsize=64)
def _scales(actual_size: tuple, original_size: tuple, flip: bool, dtype, device):
    """:func:`get_scale`'s ratio and its ``repeat_interleave`` by 2, made once per
    arguments: sizes copied from the host on each call would make the host wait
    for the card. Shared tensors: read them, never write them."""
    scale = (torch.as_tensor(original_size, dtype=dtype, device=device)
             / torch.as_tensor(actual_size, dtype=dtype, device=device))
    scale = torch.flip(scale, (-1,)) if flip else scale
    return scale, torch.repeat_interleave(scale, 2, -1)


def get_scale(actual_size, original_size, flip: bool = True, dtype=torch.float32,
              device=None) -> torch.Tensor:
    return _scales(tuple(actual_size), tuple(original_size), flip, dtype, device)[0].clone()


def scale_contours(actual_size, original_size, contours: torch.Tensor) -> torch.Tensor:
    """Scale (x, y) contours from ``actual_size`` (h, w) to ``original_size`` (h, w)."""
    scale, _ = _scales(tuple(actual_size), tuple(original_size), True, contours.dtype,
                       contours.device)
    return contours * scale


def scale_fourier(actual_size, original_size, fourier: torch.Tensor, location: torch.Tensor):
    """Scale Fourier descriptors (x slots 0, 1; y slots 2, 3) and locations."""
    scale, coef_scale = _scales(tuple(actual_size), tuple(original_size), True, fourier.dtype,
                                fourier.device)           # coef_scale: (sx, sx, sy, sy)
    return fourier * coef_scale, location * scale


def order_weighting(order: int, max_w: float = 5., min_w: float = 1., spread=None,
                    dtype=torch.float32) -> torch.Tensor:
    """Quadratically decaying per-order loss weights, ``[order, 1]``."""
    x = torch.arange(order, dtype=dtype)
    if spread is None:
        spread = order - 1
    y = min_w + (max_w - min_w) * (1. - torch.clamp(x / spread, 0., 1.)) ** 2
    return y[:, None]


def refinement_bucket_weight(index: torch.Tensor, base_index: torch.Tensor) -> torch.Tensor:
    """Triangle (linear-interpolation) weight of a refinement bucket tap; no gradient."""
    dist = (index + 0.5 - base_index).abs()
    return torch.where(dist > 1., 0., 1. - dist).detach()


def resolve_refinement_buckets(samplings: torch.Tensor, num_buckets: int):
    """The three taps ``(bucket index, triangle weight)`` of bucketed
    refinement for contour parameters ``samplings`` in [0, 1]: the bucket
    below, at and above ``samplings * num_buckets`` (truncated), wrapped
    around with ``%``."""
    base_index = samplings * num_buckets
    base_int = base_index.to(torch.int32)
    out = []
    for delta in (-1, 0, 1):
        idx = base_int + delta
        out.append((idx % num_buckets, refinement_bucket_weight(idx.to(samplings.dtype),
                                                                base_index)))
    return tuple(out)


def remove_border_contours(contours: torch.Tensor, size, padding: float = 1, top: bool = True,
                           right: bool = True, bottom: bool = True, left: bool = True,
                           offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Keep mask of ``[N, S, 2]`` (x, y) contours that do NOT touch the chosen
    border regions of a context of ``size`` (h, w), ``padding`` px thick;
    ``offsets`` (xy) are added to the contours first."""
    h, w = size[0], size[1]
    if offsets is not None:
        contours = contours + offsets
    x, y = contours[..., 0], contours[..., 1]
    keep = torch.ones(contours.shape[:-2], dtype=torch.bool, device=contours.device)
    if top:
        keep = keep & (y > padding).all(-1)
    if right:
        keep = keep & (x < (w - padding)).all(-1)
    if bottom:
        keep = keep & (y < (h - padding)).all(-1)
    if left:
        keep = keep & (x > padding).all(-1)
    return keep


def filter_contours_by_stitching_rule(contours: torch.Tensor, tile_size, overlaps,
                                      rule: str = 'ex_br',
                                      offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy stitching-rule keep mask for tiled inference.

    ``'ex_br'`` drops contours that lie wholly in the exclusive bottom or
    right overlap region, from ``tile_size - overlaps[:, 1]`` on (local
    coordinates); ``overlaps`` is ``[2, 2]``, (start, end) per axis (y, x).
    """
    if offsets is not None:
        contours = contours + offsets
    if 'ex_br' not in rule.split(','):
        raise ValueError(f'Unknown stitching rule: {rule}')
    tile_size = torch.as_tensor(tile_size, dtype=contours.dtype, device=contours.device)
    overlaps = torch.as_tensor(overlaps, dtype=contours.dtype, device=contours.device)
    stop = torch.flip(tile_size - overlaps[:, 1], (0,))          # (x, y)
    return ~(contours >= stop).any(-1).all(-1)


def batched_box_nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                    iou_threshold: float) -> torch.Tensor:
    """Exact greedy NMS per image over ``[B, N, ...]`` capacity-padded boxes.

    The batch dimension is written out: on CUDA all images share one launch.
    """
    return nms_padded(boxes, scores, valid, iou_threshold)
