"""Parts of the batch inference pipeline: input preprocessing and the model ensemble.

Counterpart of ``celldetection_tpu/runtime/cpn_inference.py``: ``preprocess``
(26-47) and ``_ensemble`` (76-107). The CLI itself (``cpn_inference``,
``main``, ``resolve_model``) needs checkpoint I/O and the h5, label and CSV
writers, and is not ported yet.
"""
from typing import Optional

import numpy as np
import torch

from ..data.misc import normalize_percentile
from ..ops.boxes import filter_by_box_voting, nms_padded
from ..parallel.tiles import KEYS, tta_inference

__all__ = ['preprocess']


def preprocess(img: np.ndarray, percentile: Optional[float] = None, gamma: float = 1.,
               contrast: float = 1., brightness: float = 0., to_rgb: bool = True) -> np.ndarray:
    """Normalise an input mosaic to float32 in [0, 1].

    uint8 inputs scale by 255; other dtypes are percentile-normalised (99.9
    when unset). Then optional gamma, contrast and brightness, and gray to RGB.
    """
    if img.dtype == np.uint8 and percentile is None:
        img = img.astype(np.float32) / 255.
    else:
        img = normalize_percentile(img, percentile if percentile is not None else 99.9)
    if gamma != 1.:
        img = np.clip(img, 0, 1) ** gamma
    if contrast != 1. or brightness != 0.:
        img = np.clip(img * contrast + brightness, 0., 1.)
    if to_rgb:
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, -1)
    return img.astype(np.float32)


def _ensemble(tiled_list, img, mask, pmask, min_vote: int, nms_thresh: float, reps: int = 1,
              point_mask_exclusive: bool = False) -> dict:
    """Multi-model ensemble: the models' detections concatenated, box voting,
    one final NMS on the first model's device."""
    if reps > 1:
        results = [tta_inference(t, img, reps=reps, mask=mask, point_mask=pmask,
                                 point_mask_exclusive=point_mask_exclusive) for t in tiled_list]
    else:
        results = [t(img, mask=mask, point_mask=pmask, point_mask_exclusive=point_mask_exclusive)
                   for t in tiled_list]
    cat = {k: np.concatenate([r[k] for r in results]) for k in KEYS
           if results[0].get(k) is not None}
    n = len(cat['boxes'])
    if n == 0:
        return dict(results[0])
    dev = tiled_list[0].model.device
    boxes = torch.from_numpy(np.ascontiguousarray(cat['boxes'])).to(dev)
    scores = torch.from_numpy(np.ascontiguousarray(cat['scores'])).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    if min_vote > 1:
        valid = filter_by_box_voting(boxes, nms_thresh, min_vote, valid)
    keep = nms_padded(boxes, scores, valid, nms_thresh).cpu().numpy()
    out = {k: v[keep] for k, v in cat.items()}
    out['num_tiles'] = sum(r.get('num_tiles', 0) for r in results)
    return out
