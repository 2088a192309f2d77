"""Host-side CPN targets → fixed-shape batches (numpy).

Counterpart of ``celldetection_tpu/data/targets.py`` (whole file): turns the
:class:`.cpn.CPNTargetGenerator` outputs into the capacity-padded arrays that
``models.cpn.cpn_compute_loss`` reads.
"""
from typing import List, Optional

import numpy as np

from .cpn import CPNTargetGenerator

__all__ = ['cpn_targets_single', 'collate_cpn_targets', 'CPNTrainItem']


def cpn_targets_single(labels: np.ndarray, samples: int, order: int,
                       rng: Optional[np.random.RandomState] = None,
                       random_sampling: bool = True, hires_targets: bool = True,
                       classes: Optional[np.ndarray] = None,
                       generator_kwargs: dict = None) -> dict:
    """One label image → target dict (un-padded instance axis).

    Returns keys: ``labels [H,W]`` (reduced, -1 = ignore), ``fourier [N,order,4]``,
    ``locations [N,2]``, ``sampled_contours [N,S,2]``,
    ``hires_sampled_contours [N,S,2]``, ``sampling [S]``, ``num_instances``.

    ``classes`` (optional): per-instance class ids indexed by input label
    value - 1. The generator may drop or renumber instances (fragment
    flagging, area filters), so classes are resolved through a class image
    painted from the input labels, which survives any relabelling. Adds
    ``classes [N]`` to the output.
    """
    labels = np.ascontiguousarray(labels)
    cls_img = None
    if classes is not None:
        classes = np.asarray(classes).reshape(-1)
        lab3 = labels if labels.ndim == 3 else labels[..., None]
        max_id = int(lab3.max()) if lab3.size else 0
        if max_id > len(classes):
            # a short or misaligned classes array fails loudly: clipping would
            # give out-of-range ids the last class
            raise ValueError(
                f'classes has {len(classes)} entries but labels contain '
                f'instance id {max_id}; classes must cover ids 1..max(labels)')
        cls_img = np.zeros(lab3.shape[:2], np.int64)
        lut = np.concatenate([[0], classes.astype(np.int64)])
        for c in range(lab3.shape[-1]):
            ch = np.clip(lab3[..., c], 0, len(classes))
            cls_img = np.where(ch > 0, lut[ch], cls_img)
    gen = CPNTargetGenerator(samples=samples, order=order, random_sampling=random_sampling,
                             rng=rng, **(generator_kwargs or {}))
    gen.feed(labels)
    out = dict(
        labels=gen.reduced_labels.astype(np.int32),
        fourier=gen.fourier.astype(np.float32),
        locations=gen.locations.astype(np.float32),
        sampled_contours=gen.sampled_contours.astype(np.float32),
        sampling=gen.sampling.astype(np.float32),
        num_instances=gen.fourier.shape[0],
    )
    if cls_img is not None:
        num = out['num_instances']
        per_inst = np.ones(num, np.int32)
        lab3 = gen.labels if gen.labels.ndim == 3 else gen.labels[..., None]
        for k in range(1, num + 1):
            mask = (lab3 == k).any(-1)
            vals = cls_img[mask]
            vals = vals[vals > 0]
            if vals.size:
                per_inst[k - 1] = np.bincount(vals).argmax()
        out['classes'] = per_inst
    if hires_targets:
        out['hires_sampled_contours'] = gen.resampled_contours.astype(np.float32)
    return out


def _pad_axis0(a: np.ndarray, n: int) -> np.ndarray:
    if a.shape[0] >= n:
        return a[:n]
    pad = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad)


def collate_cpn_targets(items: List[dict], max_instances: Optional[int] = None) -> dict:
    """Stack target dicts, padding the instance axis to ``max_instances``."""
    n = max(max(i['num_instances'] for i in items), 1)
    if max_instances is not None:
        n = max_instances
        overflow = [i['num_instances'] > n for i in items]
        if any(overflow):
            raise ValueError(f'max_instances={n} exceeded: '
                             f'{[i["num_instances"] for i in items]}')
    out = {}
    hs = [i['labels'].shape for i in items]
    assert len(set(hs)) == 1, f'Label shapes must match for batching: {hs}'
    out['labels'] = np.stack([i['labels'] for i in items])
    for k in ('fourier', 'locations', 'sampled_contours', 'hires_sampled_contours',
              'classes'):
        if k in items[0]:
            out[k] = np.stack([_pad_axis0(i[k], n) for i in items])
    out['sampling'] = np.stack([i['sampling'] for i in items])
    out['num_instances'] = np.asarray([i['num_instances'] for i in items], np.int32)
    return out


class CPNTrainItem:
    """Dataset adapter: (image, labels) pairs → (image, target dict) items."""

    def __init__(self, dataset, samples: int, order: int, seed: int = 0, **kwargs):
        self.dataset = dataset
        self.samples = samples
        self.order = order
        self.seed = seed
        self.kwargs = kwargs

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, item):
        image, labels = self.dataset[item]
        rng = np.random.RandomState((self.seed * 2654435761 + item) % (2 ** 31))
        targets = cpn_targets_single(labels.copy(), self.samples, self.order, rng=rng,
                                     **self.kwargs)
        return image, targets
