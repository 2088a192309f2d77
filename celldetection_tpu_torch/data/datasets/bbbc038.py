"""BBBC038 (the 2018 Data Science Bowl nuclei), from an extracted directory.

Counterpart of ``celldetection_tpu/data/datasets/bbbc038.py``: per-sample
``images/`` and ``masks/`` folders, the unary masks stacked into a label
image (imageio, imported on use).
"""
import os
from os.path import join

import numpy as np

from ..segmentation import unary_masks2labels

__all__ = ['BBBC038Train', 'download_bbbc038']

URLS = (
    'https://data.broadinstitute.org/bbbc/BBBC038/stage1_train.zip',
    'https://data.broadinstitute.org/bbbc/BBBC038/stage1_test.zip',
    'https://data.broadinstitute.org/bbbc/BBBC038/stage2_test_final.zip',
)


def download_bbbc038(directory: str):
    """Download and extract BBBC038 (https://bbbc.broadinstitute.org/BBBC038)."""
    from ._dl import download_and_extract
    for url in URLS:
        stage = url.rsplit('/', 1)[-1].rsplit('.', 1)[0]
        download_and_extract(url, directory, extract_to=join(directory, stage))


class BBBC038Train:
    """BBBC038's stage1 train split: items ``(name, image, labels)``.

    Args:
        directory: Directory of per-sample folders, each with
            ``images/*.png`` and ``masks/*.png``.
    """

    def __init__(self, directory: str):
        self.directory = directory
        self.names = sorted(d for d in os.listdir(directory)
                            if os.path.isdir(join(directory, d)))

    def __len__(self):
        return len(self.names)

    def __getitem__(self, item):
        from imageio.v2 import imread
        name = self.names[item]
        img_dir = join(self.directory, name, 'images')
        mask_dir = join(self.directory, name, 'masks')
        image_fn, = [f for f in os.listdir(img_dir) if not f.startswith('.')]
        image = imread(join(img_dir, image_fn))
        masks = [imread(join(mask_dir, f)) for f in sorted(os.listdir(mask_dir))
                 if not f.startswith('.')]
        labels = unary_masks2labels(np.stack(masks) > 0)
        return name, image, labels
