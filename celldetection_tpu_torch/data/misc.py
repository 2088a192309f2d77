"""Host-side image and contour helpers (numpy).

Counterpart of ``celldetection_tpu/data/misc.py``: ``normalize_percentile``
(79-100), ``random_crop`` (103-111), ``random_pad`` (114-124) and
``resample_contours`` (143-179), copied so that the port imports nothing of
the JAX package.
"""
from typing import Union

import numpy as np

__all__ = ['normalize_percentile', 'random_crop', 'random_pad', 'resample_contours']


def normalize_percentile(image: np.ndarray, percentile=99.9, to_uint8: bool = False,
                         lower: float = None) -> np.ndarray:
    """Two-sided percentile normalisation to [0, 1] (optionally uint8).

    Maps the (100 - p)th..pth percentile window to [0, 1] with clipping, so a
    camera baseline is removed, not just divided through. ``percentile`` may
    be a (low, high) tuple; ``lower`` overrides the low percentile.
    """
    if isinstance(percentile, (list, tuple)):
        p_low, p_high = percentile
    else:
        p_low, p_high = 100. - percentile, percentile
    if lower is not None:
        p_low = lower
    low, high = np.percentile(image, (p_low, p_high))
    denom = max(high - low, 1e-12)
    img = (image.astype('float32') - low) / denom
    img = np.clip(img, 0., 1.)
    if to_uint8:
        img = (img * 255).astype('uint8')
    return img


def random_crop(*arrays, height: int, width: int = None, rng: np.random.RandomState = None):
    """Random crop applied consistently to all inputs (leading spatial dims)."""
    rng = rng or np.random
    width = width or height
    h, w = arrays[0].shape[:2]
    y = rng.randint(0, max(h - height, 0) + 1)
    x = rng.randint(0, max(w - width, 0) + 1)
    out = tuple(a[y:y + height, x:x + width] for a in arrays)
    return out if len(out) > 1 else out[0]


def random_pad(*arrays, height: int, width: int = None, rng: np.random.RandomState = None,
               **kwargs):
    """Random split of the padding that brings every input to at least (height, width)."""
    rng = rng or np.random
    width = width or height
    h, w = arrays[0].shape[:2]
    ph, pw = max(0, height - h), max(0, width - w)
    ty, tx = (rng.randint(0, p + 1) if p else 0 for p in (ph, pw))
    out = tuple(np.pad(a, [(ty, ph - ty), (tx, pw - tx)] + [(0, 0)] * (a.ndim - 2), **kwargs)
                for a in arrays)
    return out if len(out) > 1 else out[0]


def resample_contours(contours, num: Union[int, float, None] = None, close: bool = True,
                      epsilon: float = 1e-6):
    """Sample ``num`` points at equal arc length along each contour ``[..., p, 2]``.

    A list or tuple of such arrays is resampled item by item. The targets are
    located on every row's arc-length profile by one flat ``searchsorted``
    (each row shifted into a range of its own).
    """
    if isinstance(contours, (list, tuple)):
        return type(contours)(resample_contours(c, num=num, close=close, epsilon=epsilon)
                              for c in contours)
    pts = np.asarray(contours, dtype=float)
    if close:
        pts = np.concatenate((pts, pts[..., :1, :]), -2)
    seg_len = np.linalg.norm(np.diff(pts, axis=-2), axis=-1) + epsilon
    arc = np.concatenate([np.zeros(seg_len.shape[:-1] + (1,), seg_len.dtype),
                          np.cumsum(seg_len, axis=-1)], axis=-1)
    total = arc[..., -1]
    if num is None or isinstance(num, float):
        num = int(np.max(np.round(total)) * (num if isinstance(num, float) else 1))
    t = total[..., None] * (np.arange(num, dtype=float) / num)

    p = pts.shape[-2]
    flat_arc = arc.reshape(-1, p)
    flat_t = t.reshape(-1, num)
    flat_pts = pts.reshape(-1, p, 2)
    rows = flat_arc.shape[0]
    stride = float(flat_arc[:, -1].max()) + 1.0
    shift = np.arange(rows, dtype=float)[:, None] * stride
    ins = np.searchsorted((flat_arc + shift).ravel(), (flat_t + shift).ravel())
    k = np.maximum(ins.reshape(rows, num) - np.arange(rows)[:, None] * p, 1) - 1
    r = np.arange(rows)[:, None]
    alpha = ((flat_t - flat_arc[r, k]) / (flat_arc[r, k + 1] - flat_arc[r, k]))[..., None]
    out = flat_pts[r, k] * (1 - alpha) + flat_pts[r, k + 1] * alpha
    return out.reshape(pts.shape[:-2] + (num, 2))
