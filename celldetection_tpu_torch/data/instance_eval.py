"""Instance-segmentation metrics: pixel-overlap label matching (numpy).

The port's copy of ``celldetection_tpu/data/instance_eval.py``
(``matching_labels``, ``LabelMatcher``, ``LabelMatcherList``; behavioural
reference ``celldetection/data/instance_eval.py``: ``matching_labels`` (:22),
``LabelMatcher`` (:99), ``LabelMatcherList`` (:262)).

Distributed aggregation: instead of ``torch.distributed.all_reduce`` the list
accepts a ``reduce_fn(values: np.ndarray) -> np.ndarray`` hook, which sums
the counts over processes.
"""
from typing import Union
from warnings import warn

import numpy as np

__all__ = ['LabelMatcher', 'LabelMatcherList', 'matching_labels']


def get_pos_labels(v):
    labels = np.unique(v)
    return labels[labels > 0]


def matching_labels(a: np.ndarray, b: np.ndarray):
    """All (input_label, target_label) pixel-overlap pairs and their counts.

    Channels encode overlapping instances: a pixel supports one intersection
    pixel for every distinct pair of positive labels found across the two
    channel axes at that location. Fully vectorized: channel pairs are swept
    as flat array passes and deduplicated per pixel with a single
    ``np.unique`` over (pixel, label_a, label_b) triples — no per-pixel
    Python loop (behavioral parity with the reference's pixel-overlap
    counting, ``celldetection/data/instance_eval.py``).
    """
    if a.ndim == 2:
        a = a[..., None]
    if b.ndim == 2:
        b = b[..., None]
    n_pix = int(np.prod(a.shape[:-1]))
    af = a.reshape(n_pix, a.shape[-1]).astype(np.int64, copy=False)
    bf = b.reshape(n_pix, b.shape[-1]).astype(np.int64, copy=False)
    pix = np.arange(n_pix, dtype=np.int64)
    triples = []
    for i in range(af.shape[1]):
        la = af[:, i]
        for j in range(bf.shape[1]):
            lb = bf[:, j]
            hit = (la > 0) & (lb > 0)
            if hit.any():
                triples.append(np.stack((pix[hit], la[hit], lb[hit]), axis=1))
    if not triples:
        return np.zeros((0, 2), dtype=np.int64), np.zeros((0,), dtype=np.int64)
    triples = np.concatenate(triples, axis=0)
    # Per-pixel dedup: identical (label_a, label_b) at one pixel counts once.
    triples = np.unique(triples, axis=0)
    matches, counts = np.unique(triples[:, 1:], axis=0, return_counts=True)
    return matches, counts


def _label_areas(labels: np.ndarray) -> dict:
    """Pixel area per positive label (zero/background excluded up front)."""
    fg = labels[labels > 0]
    uni, cnt = np.unique(fg, return_counts=True)
    return dict(zip(uni.tolist(), cnt.tolist()))


class LabelMatcher:
    """Greedy one-to-one IoU matching of predicted vs target label images.

    The IoU threshold is the minimum IoU for two objects to count as a match;
    each target matches at most one prediction and vice versa (greedy by IoU).
    """

    def __init__(self, inputs=None, targets=None, iou_thresh=None, zero_division='warn',
                 epsilon: float = 1e-12):
        self._iou_thresh = 0. if iou_thresh is None else iou_thresh
        self._sel = None
        self.ious = self.unions = self.input_labels = None
        self.target_labels = self.matches = self.intersections = None
        self.input_counts = self.target_counts = None
        self.zero_division = zero_division if isinstance(zero_division, int) else 0
        self.zero_division_warn = zero_division == 'warn'
        self.epsilon = epsilon
        if inputs is not None and targets is not None:
            self.update(inputs, targets, iou_thresh)

    def _require_update(self):
        if self.matches is None:
            raise ValueError('No labels added yet; call update() before reading results.')

    def update(self, inputs, targets, iou_thresh=None):
        inputs = inputs[:, :, None] if inputs.ndim == 2 else inputs
        targets = targets[:, :, None] if targets.ndim == 2 else targets
        self.input_labels = get_pos_labels(inputs)
        self.target_labels = get_pos_labels(targets)
        self.matches, self.intersections = matching_labels(inputs, targets)
        self.input_counts = _label_areas(inputs)
        self.target_counts = _label_areas(targets)
        self.unions = np.array(
            [self.input_counts[i] + self.target_counts[j] for (i, j) in self.matches]
        ) - self.intersections
        self.ious = self.intersections / np.maximum(self.unions, 1)
        self.iou_thresh = self.iou_thresh if iou_thresh is None else iou_thresh

    def filter_and_threshold(self):
        """Greedy one-to-one selection by descending IoU above threshold."""
        self._require_update()
        matches, ious = self.matches, self.ious
        indices = np.argsort(ious)[::-1]
        self._sel = ious >= self.iou_thresh
        for i, index in enumerate(indices):
            if not self._sel[index]:
                continue
            iou_pass = ious[index] >= self.iou_thresh
            self._sel[index] = iou_pass
            if not iou_pass or i + 1 >= len(indices):
                continue
            rest = indices[i + 1:]
            conflict = (matches[index:index + 1] == matches[rest]).any(-1)
            self._sel[rest[conflict]] = False

    @property
    def iou_thresh(self):
        return self._iou_thresh

    @iou_thresh.setter
    def iou_thresh(self, v):
        assert self.ious is not None
        self._iou_thresh = v
        self.filter_and_threshold()

    @property
    def true_positive_labels(self):
        self._require_update()
        return set(self.matches[:, 0][self._sel]) if len(self.matches) > 0 else set()

    @property
    def true_positives(self):
        return len(self.true_positive_labels)

    @property
    def false_positive_labels(self):
        self._require_update()
        matched = set(self.matches[:, 0][self._sel]) if len(self.matches) > 0 else set()
        return set(self.input_labels) - matched

    @property
    def false_positives(self):
        return len(self.false_positive_labels)

    @property
    def false_negative_labels(self):
        self._require_update()
        matched = set(self.matches[:, 1][self._sel]) if len(self.matches) > 0 else set()
        return set(self.target_labels) - matched

    @property
    def false_negatives(self):
        return len(self.false_negative_labels)

    def _zero_div(self, name):
        if self.zero_division_warn:
            warn(f'ZeroDivisionError in {name} calculation. Assuming {self.zero_division} as result.')
        return self.zero_division

    @property
    def precision(self):
        tp, fp = self.true_positives, self.false_positives
        if tp + fp == 0:
            return self._zero_div('precision')
        return tp / (tp + fp + self.epsilon)

    @property
    def recall(self):
        tp, fn = self.true_positives, self.false_negatives
        if tp + fn == 0:
            return self._zero_div('recall')
        return tp / (tp + fn + self.epsilon)

    @property
    def f1(self):
        pr, rc = self.precision, self.recall
        if pr + rc == 0:
            return self._zero_div('f1')
        return (2 * pr * rc) / (pr + rc + self.epsilon)

    @property
    def jaccard(self):
        tp, fp, fn = self.true_positives, self.false_positives, self.false_negatives
        if tp + fn + fp == 0:
            return self._zero_div('jaccard')
        return tp / (tp + fn + fp + self.epsilon)

    @property
    def fowlkes_mallows(self):
        tp, fp, fn = self.true_positives, self.false_positives, self.false_negatives
        denom = np.sqrt((tp + fp) * (tp + fn) + self.epsilon)
        if denom == 0:
            return self._zero_div('fowlkes_mallows')
        return tp / denom


class LabelMatcherList(list):
    """Aggregation over a list of :class:`LabelMatcher` objects.

    Args:
        reduce_fn: Optional cross-host reduction hook; called with a 1d float
            array of partial sums, must return the globally reduced array.
            Defaults to identity (local-only).
    """

    def __init__(self, *args, epsilon: float = 1e-12, reduce_fn=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.epsilon = epsilon
        self.reduce_fn = reduce_fn
        self._iou_thresh = None

    def _reduce(self, values):
        values = np.asarray(values, dtype=np.float64)
        if self.reduce_fn is not None:
            values = np.asarray(self.reduce_fn(values))
        return values

    @property
    def iou_thresh(self):
        if len(self):
            thresholds = np.unique([s.iou_thresh for s in self])
            if len(thresholds) == 1:
                thresholds, = thresholds
            return thresholds
        return self._iou_thresh

    @iou_thresh.setter
    def iou_thresh(self, v):
        self._iou_thresh = v
        for s in self:
            s.iou_thresh = v

    @property
    def length(self) -> int:
        return int(self._reduce([len(self)])[0])

    def _avg_x(self, x) -> float:
        attributes = [getattr(m, x) for m in self]
        local_sum = float(np.sum(attributes)) if attributes else 0.
        local_count = float(len(attributes))
        total_sum, total_count = self._reduce([local_sum, local_count])
        return total_sum / total_count if total_count else 0

    def _sum_x(self, x) -> Union[int, float]:
        local_sum = float(np.sum([getattr(m, x) for m in self]))
        return self._reduce([local_sum])[0]

    @property
    def false_positives(self):
        return self._sum_x('false_positives')

    @property
    def false_negatives(self):
        return self._sum_x('false_negatives')

    @property
    def true_positives(self):
        return self._sum_x('true_positives')

    @property
    def f1(self):
        """F1 from average recall and precision."""
        recall, precision = self.avg_recall, self.avg_precision
        if recall + precision == 0:
            return 0
        return (2 * recall * precision) / (recall + precision + self.epsilon)

    @property
    def f1_np(self):
        """F1 from summed negatives and positives."""
        tp, fn, fp = self.true_positives, self.false_negatives, self.false_positives
        return (2 * tp) / (2 * tp + fn + fp + self.epsilon)

    @property
    def jaccard_np(self):
        tp, fn, fp = self.true_positives, self.false_negatives, self.false_positives
        return tp / (tp + fn + fp + self.epsilon)

    @property
    def fowlkes_mallows_np(self):
        tp, fn, fp = self.true_positives, self.false_negatives, self.false_positives
        return tp / np.sqrt((tp + fp) * (tp + fn) + self.epsilon)

    @property
    def avg_f1(self):
        return self._avg_x('f1')

    @property
    def avg_jaccard(self):
        return self._avg_x('jaccard')

    @property
    def avg_fowlkes_mallows(self):
        return self._avg_x('fowlkes_mallows')

    @property
    def avg_recall(self):
        return self._avg_x('recall')

    @property
    def avg_precision(self):
        return self._avg_x('precision')

    @property
    def precision(self):
        tp, fp = self.true_positives, self.false_positives
        return tp / (tp + fp + self.epsilon)

    @property
    def recall(self):
        tp, fn = self.true_positives, self.false_negatives
        return tp / (tp + fn + self.epsilon)
