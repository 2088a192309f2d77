"""Image normalisation for inference (numpy).

Counterpart of ``celldetection_tpu/data/misc.py: normalize_percentile``
(lines 79-100), copied so that the port imports nothing of the JAX package.
"""
import numpy as np

__all__ = ['normalize_percentile']


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
