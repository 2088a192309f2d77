"""Minimal region-properties engine on ``scipy.ndimage`` (no scikit-image).

A copy of ``celldetection_tpu/data/_regionprops.py``: ``regionprops`` gives
the subset of ``skimage.measure.regionprops`` that the target pipeline needs
(label, bbox, image, coords, area, centroid), ``connected_label`` the
semantics of ``skimage.morphology.label``.
"""
from typing import List

import numpy as np
from scipy import ndimage as ndi

__all__ = ['RegionProps', 'regionprops', 'connected_label']


class RegionProps:
    """One labeled region. ``bbox`` follows skimage order (min_row, min_col[, ...], max_row, max_col[, ...])."""

    def __init__(self, label: int, sl, labels: np.ndarray, spacing=None):
        self.label = int(label)
        self._sl = sl
        self._labels = labels
        if spacing is None:
            self._spacing = None
        else:
            # scalar / length-1 spacing is isotropic: broadcast to image ndim
            # so area scales by spacing**ndim
            self._spacing = np.broadcast_to(
                np.atleast_1d(np.asarray(spacing, float)), (labels.ndim,)).copy()

    @property
    def bbox(self):
        mins = tuple(s.start for s in self._sl)
        maxs = tuple(s.stop for s in self._sl)
        return mins + maxs

    @property
    def image(self) -> np.ndarray:
        return self._labels[self._sl] == self.label

    @property
    def coords(self) -> np.ndarray:
        offset = np.array([s.start for s in self._sl])
        return np.argwhere(self.image) + offset

    @property
    def area(self):
        """Pixel count, scaled to physical units when ``spacing`` is set."""
        n = int(self.image.sum())
        if self._spacing is None:
            return n
        return float(n * np.prod(self._spacing))

    @property
    def centroid(self):
        """Center of mass; in physical units when ``spacing`` is set."""
        c = self.coords.mean(0)
        if self._spacing is not None:
            c = c * self._spacing
        return tuple(c)


def regionprops(labels: np.ndarray, spacing=None) -> List[RegionProps]:
    """Region properties of positive labels in a label image (any ndim)."""
    labels = np.asarray(labels)
    if labels.size == 0:
        return []
    pos = np.where(labels > 0, labels, 0)
    max_label = int(pos.max()) if pos.size else 0
    if max_label == 0:
        return []
    slices = ndi.find_objects(pos, max_label=max_label)
    out = []
    for lbl, sl in enumerate(slices, 1):
        if sl is None:
            continue
        out.append(RegionProps(lbl, sl, pos, spacing=spacing))
    return out


def connected_label(image: np.ndarray, connectivity: int = 2) -> np.ndarray:
    """Label connected regions of equal positive value (skimage.morphology.label semantics).

    Distinct non-zero values are never merged; disconnected same-value regions
    get distinct labels. Background (<= 0) stays 0.
    """
    image = np.asarray(image)
    structure = ndi.generate_binary_structure(image.ndim, connectivity)
    out = np.zeros(image.shape, dtype=np.int32)
    nxt = 0
    for v in np.unique(image):
        if v <= 0:
            continue
        lab, n = ndi.label(image == v, structure=structure)
        out[lab > 0] = lab[lab > 0] + nxt
        nxt += n
    return out
