"""Label-image filters of the target pipeline (numpy).

Counterpart of ``celldetection_tpu/data/segmentation.py``: ``remove_partials_``
(18-33), ``fill_label_gaps_`` (36-47) and ``filter_instances_`` (81-101),
without its module-level cv2 import.
"""
import numpy as np

__all__ = ['remove_partials_', 'fill_label_gaps_', 'filter_instances_']


def remove_partials_(label_stack: np.ndarray, border: int = 1, constant: int = -1):
    """Inplace: set every label that touches the image border to ``constant``.

    The positive labels found in the border strips of the first two axes are
    overwritten everywhere in one ``np.isin`` pass. Returns ``(labels, mask)``.
    """
    if border < 1:
        return label_stack, None
    strips = (label_stack[:border], label_stack[-border:],
              label_stack[:, :border], label_stack[:, -border:])
    edge_labels = np.unique(np.concatenate([s.ravel() for s in strips]))
    edge_labels = edge_labels[edge_labels != 0]
    mask = np.isin(label_stack, edge_labels)
    label_stack[mask] = constant
    return label_stack, mask


def fill_label_gaps_(labels: np.ndarray):
    """Inplace: renumber the positive labels densely to 1..n; labels <= 0 stay."""
    fg = labels > 0
    if not fg.any():
        return
    _, dense = np.unique(labels[fg], return_inverse=True)
    labels[fg] = dense + 1


def filter_instances_(labels: np.ndarray, partials: bool = True, partials_border: int = 1,
                      min_area: int = 4, max_area: int = None, constant: int = -1,
                      continuous: bool = True):
    """Inplace instance filter: border partials, area bounds, dense renumbering.

    Instances that touch the border (``partials``) or whose pixel count lies
    outside ``[min_area, max_area]`` become ``constant``.
    """
    if partials:
        remove_partials_(labels, border=partials_border, constant=constant)
    if min_area or max_area:
        uni, area = np.unique(labels[labels > 0], return_counts=True)
        out = np.zeros(uni.shape, bool)
        if min_area:
            out |= area < min_area
        if max_area:
            out |= area > max_area
        if out.any():
            labels[np.isin(labels, uni[out])] = constant
    if continuous:
        fill_label_gaps_(labels)
