"""Stage-dispatched transforms (numpy).

Counterpart of ``celldetection_tpu/data/transforms.py``: ``Transforms``
(15-37) dispatches on the pipeline stage (fit, validate, test, predict);
``BasicTransforms`` (40-76) crops, normalises by percentile, converts
grayscale to RGB and scales to [0, 1].
"""
import numpy as np

from .misc import normalize_percentile, random_crop

__all__ = ['Transforms', 'BasicTransforms']


class Transforms:
    """Base: dispatch to ``transform_<stage>``; a stage without one passes its data through."""

    STAGES = ('fit', 'validate', 'test', 'predict')

    def __call__(self, stage: str, **data):
        fn = getattr(self, f'transform_{stage}', None)
        if fn is None:
            return data
        return fn(**data)

    def transform_fit(self, **data):
        return data

    def transform_validate(self, **data):
        return data

    def transform_test(self, **data):
        return data

    def transform_predict(self, **data):
        return data


class BasicTransforms(Transforms):
    """Random crop (fit only), percentile normalisation (uint8: divide by
    255) and grayscale to RGB."""

    def __init__(self, crop_size=None, percentile: float = 99.9, to_rgb: bool = True,
                 rng: np.random.RandomState = None):
        if isinstance(crop_size, int):
            crop_size = (crop_size, crop_size)
        self.crop_size = crop_size
        self.percentile = percentile
        self.to_rgb = to_rgb
        self.rng = rng or np.random

    def _norm(self, image):
        if image.dtype == np.uint8:
            image = image.astype(np.float32) / 255.
        else:
            image = normalize_percentile(image, self.percentile)
        if self.to_rgb and (image.ndim == 2 or image.shape[-1] == 1):
            if image.ndim == 2:
                image = image[..., None]
            image = np.repeat(image, 3, -1)
        return image

    def transform_fit(self, image=None, labels=None, **extra):
        if self.crop_size is not None:
            if labels is not None:
                image, labels = random_crop(image, labels, height=self.crop_size[0],
                                            width=self.crop_size[1], rng=self.rng)
            else:
                image = random_crop(image, height=self.crop_size[0], width=self.crop_size[1],
                                    rng=self.rng)
        return dict(image=self._norm(image), labels=labels, **extra)

    def transform_validate(self, image=None, labels=None, **extra):
        return dict(image=self._norm(image), labels=labels, **extra)

    transform_test = transform_validate

    def transform_predict(self, image=None, **extra):
        return dict(image=self._norm(image), **extra)
