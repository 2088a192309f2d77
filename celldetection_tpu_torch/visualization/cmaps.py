"""Colour maps for label images.

Counterpart of ``celldetection_tpu/visualization/cmaps.py``: ``random_colors_hsv``
(11) and ``label_cmap`` (24). cv2's ``cvtColor(HSV2RGB)`` of the colours as
one image row is the port's own :func:`..data.cpn.hsv2rgb_uint8` with
``row_lanes=32``: cv2's vector loop on a CPU with AVX2, which converts back
by truncation, and its one-pixel code for the row's last ``num % 32``.
"""
import numpy as np

from ..data.cpn import hsv2rgb_uint8
from .images import to_host

__all__ = ['random_colors_hsv', 'label_cmap']


def random_colors_hsv(num: int, hue_range=(0, 180), saturation_range=(60, 256),
                      value_range=(128, 256), ubyte: bool = True, seed=None):
    """``num`` random RGB colours drawn in HSV (cv2's conventions: hue 0-179)."""
    rng = np.random.RandomState(seed)
    hsv = np.stack([rng.randint(*hue_range, num), rng.randint(*saturation_range, num),
                    rng.randint(*value_range, num)], -1).astype(np.uint8)
    rgb = hsv2rgb_uint8(hsv, row_lanes=32)
    if not ubyte:
        rgb = rgb.astype(np.float32) / 255.
    return [tuple(c) for c in rgb]


def label_cmap(labels, seed=None, background=(0, 0, 0)) -> np.ndarray:
    """Label image (numpy or tensor) → RGB uint8 image, one random colour per label."""
    labels = to_host(labels)
    if labels.ndim == 3:
        labels = labels.max(-1)
    n = int(labels.max())
    colors = np.array([background] + random_colors_hsv(max(n, 1), seed=seed), np.uint8)
    return colors[np.clip(labels, 0, n)]
