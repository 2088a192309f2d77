"""Label-image utilities (numpy, scipy).

Counterpart of ``celldetection_tpu/data/segmentation.py``: ``remove_partials_``
(18-33), ``fill_label_gaps_`` (36-47), ``fill_padding_`` (50-68),
``remove_padding`` (71-78), ``filter_instances_`` (81-101), ``relabel_``
(104-122), ``stack_labels`` (125-131), ``unary_masks2labels`` (134-139) and
``boxes2masks`` (142-149), without cv2: ``boxes2masks`` fills its boxes
as ``cv2.rectangle(..., thickness=-1)`` does (:func:`._draw.rectangle`).
"""
import numpy as np

from . import _draw
from ._regionprops import connected_label
from .misc import rgb_to_scalar

__all__ = ['remove_partials_', 'fill_label_gaps_', 'filter_instances_', 'relabel_', 'stack_labels',
           'unary_masks2labels', 'boxes2masks', 'fill_padding_', 'remove_padding']


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


def fill_padding_(inputs, padding: int, constant: int = -1, preserve_existing: bool = True,
                  axes=(0, 1)):
    """Inplace: mark the ``padding`` border rows/columns with ``constant``.

    With ``preserve_existing`` only pixels that are zero across the trailing
    axis are overwritten, so padding never clobbers a real instance.
    """
    if padding <= 0:
        return
    if isinstance(inputs, (list, tuple)):
        for item in inputs:
            fill_padding_(item, padding, constant, preserve_existing, axes)
        return
    for ax in axes:
        view = np.moveaxis(inputs, ax % inputs.ndim, 0)
        for band in (view[:padding], view[-padding:]):
            if preserve_existing:
                band[~band.any(-1)] = constant
            else:
                band[...] = constant


def remove_padding(inputs, padding: int):
    """Crop ``padding`` rows/columns from both sides of the leading two axes."""
    if isinstance(inputs, (list, tuple)):
        return [remove_padding(item, padding) for item in inputs]
    if padding <= 0:  # slice(0, -0) would be empty
        return inputs
    crop = (slice(padding, -padding),) * 2
    return inputs[crop]


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


def relabel_(label_stack: np.ndarray, axis: int = 2):
    """Inplace: renumber each channel's connected components 1, 2, ... across
    the channels; a component that touches a negative label keeps its value."""
    assert label_stack.ndim == 3
    neg_m = label_stack < 0
    cur_max = 0
    for channel in range(label_stack.shape[axis]):
        sel = (slice(None),) * axis + (channel,)
        stack_ = connected_label(label_stack[sel])
        for u in set(np.unique(stack_)) - {0}:
            mask = stack_ == u
            if np.any(np.logical_and(mask, neg_m[sel])):
                continue
            cur_max += 1
            label_stack[sel][mask] = cur_max


def stack_labels(*maps, axis: int = 2, dtype='int32', relabel: bool = True) -> np.ndarray:
    """Stack grayscale or RGB label maps into a channelled label image."""
    maps = [(rgb_to_scalar(m, dtype=dtype) if (m.ndim == 3 and m.shape[2] == 3)
             else m.astype(dtype)) for m in maps]
    stack = np.stack(maps, axis=axis)
    if relabel:
        relabel_(stack, axis)
    return stack


def unary_masks2labels(unary_masks, transpose: bool = True) -> np.ndarray:
    """Per-object binary masks ``[n, h, w]`` → a label image, one channel per object."""
    lbl = (np.asarray(unary_masks) > 0) * np.arange(1, len(unary_masks) + 1)[:, None, None]
    if transpose:
        lbl = lbl.transpose((1, 2, 0))
    return lbl


def boxes2masks(boxes, size):
    """Boxes ``(xmin, ymin, xmax, ymax)`` → filled rectangle masks (label index + 1)."""
    masks = []
    for idx, b in enumerate(boxes):
        mask = np.zeros(size, dtype='uint8')
        xmin, ymin, xmax, ymax = (int(v) for v in b)
        _draw.rectangle(mask, (xmin, ymin), (xmax, ymax), idx + 1)
        masks.append(mask)
    return masks
