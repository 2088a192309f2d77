"""Training augmentations (numpy, joint image and labels transforms), without cv2.

Counterpart of ``celldetection_tpu/data/augmentation.py``: the nine
augmentations (23-153), ``Compose`` (156-177) and ``conf2augmentation``
(185-191). Each draws the same numbers from the same ``RandomState`` in the
same order as the JAX package. ``ElasticTransform`` blurs and remaps with
:mod:`._draw`, which gives what ``cv2.GaussianBlur`` and ``cv2.remap`` give,
bit for bit::

    aug = conf2augmentation({
        'RandomRotate90': {'p': 0.5},
        'HorizontalFlip': {'p': 0.5},
        'RandomBrightnessContrast': {'p': 0.3},
    })
    image, labels = aug(image, labels, rng)
"""
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from . import _draw

__all__ = ['conf2augmentation', 'Compose', 'HorizontalFlip', 'VerticalFlip', 'RandomRotate90',
           'Transpose', 'RandomBrightnessContrast', 'GaussNoise', 'RandomGamma', 'RandomCrop',
           'ElasticTransform']


class _Aug:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, image, labels=None, rng=None):
        rng = rng or np.random
        if rng.rand() >= self.p:
            return image, labels
        return self.apply(image, labels, rng)

    def apply(self, image, labels, rng):
        raise NotImplementedError


class HorizontalFlip(_Aug):
    def apply(self, image, labels, rng):
        return np.ascontiguousarray(image[:, ::-1]), \
            None if labels is None else np.ascontiguousarray(labels[:, ::-1])


class VerticalFlip(_Aug):
    def apply(self, image, labels, rng):
        return np.ascontiguousarray(image[::-1]), \
            None if labels is None else np.ascontiguousarray(labels[::-1])


class Transpose(_Aug):
    def apply(self, image, labels, rng):
        perm_i = (1, 0) + tuple(range(2, image.ndim))
        out_l = None
        if labels is not None:
            perm_l = (1, 0) + tuple(range(2, labels.ndim))
            out_l = np.ascontiguousarray(labels.transpose(perm_l))
        return np.ascontiguousarray(image.transpose(perm_i)), out_l


class RandomRotate90(_Aug):
    def apply(self, image, labels, rng):
        k = rng.randint(1, 4)
        return np.ascontiguousarray(np.rot90(image, k)), \
            None if labels is None else np.ascontiguousarray(np.rot90(labels, k))


class RandomBrightnessContrast(_Aug):
    def __init__(self, brightness_limit: float = 0.2, contrast_limit: float = 0.2, p: float = 0.5):
        super().__init__(p)
        self.brightness_limit = brightness_limit
        self.contrast_limit = contrast_limit

    def apply(self, image, labels, rng):
        b = rng.uniform(-self.brightness_limit, self.brightness_limit)
        c = 1. + rng.uniform(-self.contrast_limit, self.contrast_limit)
        return np.clip(image * c + b, 0., 1.).astype(image.dtype), labels


class RandomGamma(_Aug):
    def __init__(self, gamma_limit: Tuple[float, float] = (0.7, 1.5), p: float = 0.5):
        super().__init__(p)
        # albumentations configs give gamma in PERCENT (e.g. (80, 120));
        # accept both so reference configs transfer unchanged
        if min(gamma_limit) > 10:
            gamma_limit = tuple(g / 100. for g in gamma_limit)
        self.gamma_limit = gamma_limit

    def apply(self, image, labels, rng):
        g = rng.uniform(*self.gamma_limit)
        return np.clip(image, 0, 1) ** g, labels


class GaussNoise(_Aug):
    def __init__(self, var_limit: Tuple[float, float] = (0.0005, 0.005), p: float = 0.5):
        super().__init__(p)
        # albumentations configs give variance in 0-255 intensity units
        # (e.g. (10, 50)); rescale to the [0, 1] domain used here
        if max(var_limit) > 1:
            var_limit = tuple(v / 255. ** 2 for v in var_limit)
        self.var_limit = var_limit

    def apply(self, image, labels, rng):
        var = rng.uniform(*self.var_limit)
        noise = rng.randn(*image.shape) * np.sqrt(var)
        return np.clip(image + noise, 0., 1.).astype(image.dtype), labels


class RandomCrop(_Aug):
    def __init__(self, height: int, width: Optional[int] = None, p: float = 1.0):
        super().__init__(p)
        self.height = height
        self.width = width or height

    def apply(self, image, labels, rng):
        h, w = image.shape[:2]
        y = rng.randint(0, max(h - self.height, 0) + 1)
        x = rng.randint(0, max(w - self.width, 0) + 1)
        img = image[y:y + self.height, x:x + self.width]
        lbl = None if labels is None else labels[y:y + self.height, x:x + self.width]
        return img, lbl


class ElasticTransform(_Aug):
    """Elastic deformation (labels warped with nearest interpolation)."""

    def __init__(self, alpha: float = 30., sigma: float = 6., p: float = 0.3):
        super().__init__(p)
        self.alpha = alpha
        self.sigma = sigma

    def apply(self, image, labels, rng):
        h, w = image.shape[:2]
        dx = _draw.gaussian_blur((rng.rand(h, w) * 2 - 1).astype(np.float32), (0, 0),
                                 self.sigma) * self.alpha
        dy = _draw.gaussian_blur((rng.rand(h, w) * 2 - 1).astype(np.float32), (0, 0),
                                 self.sigma) * self.alpha
        xs, ys = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
        map_x, map_y = xs + dx, ys + dy
        img = _draw.remap_linear(image.astype(np.float32), map_x, map_y)
        lbl = None
        if labels is not None:
            lbl = _draw.remap_nearest(labels.astype(np.float32), map_x, map_y).astype(labels.dtype)
        return img.astype(image.dtype), lbl


class Compose:
    """Sequential joint image+labels pipeline.

    Intensity augs operate on float images in [0, 1]; uint8 inputs are
    converted in and back out transparently (clipping to [0, 1] and casting
    to uint8 mid-pipeline would flatten the image to {0, 1}).
    """

    def __init__(self, transforms: List[Callable]):
        self.transforms = transforms

    def __call__(self, image, labels=None, rng=None):
        rng = rng or np.random
        was_uint8 = image.dtype == np.uint8
        if was_uint8:
            image = image.astype(np.float32) / 255.
        for t in self.transforms:
            image, labels = t(image, labels, rng)
        if was_uint8:
            image = np.round(np.clip(image, 0., 1.) * 255.).astype(np.uint8)
        return image, labels


_REGISTRY = {c.__name__: c for c in
             (HorizontalFlip, VerticalFlip, Transpose, RandomRotate90,
              RandomBrightnessContrast, RandomGamma, GaussNoise, RandomCrop,
              ElasticTransform)}


def conf2augmentation(settings: Dict[str, dict]) -> Compose:
    """``{'HorizontalFlip': {'p': .5}, ...}`` → :class:`Compose` pipeline
    (albumentations names where the operation exists here)."""
    return Compose([_REGISTRY[k](**(v or {})) for k, v in settings.items()])
