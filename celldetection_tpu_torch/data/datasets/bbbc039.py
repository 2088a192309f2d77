"""BBBC039 nuclei (train, validation and test splits from the metadata lists).

Counterpart of ``celldetection_tpu/data/datasets/bbbc039.py``. Images are
read with imageio (imported on use); ``download=False`` reads a directory
that already holds ``images/``, ``masks/`` and ``metadata/``.
"""
from os.path import join

from .._regionprops import connected_label

__all__ = ['download_bbbc039', 'BBBC039Train', 'BBBC039Test', 'BBBC039Val']

URLS = [
    'https://data.broadinstitute.org/bbbc/BBBC039/images.zip',
    'https://data.broadinstitute.org/bbbc/BBBC039/metadata.zip',
    'https://data.broadinstitute.org/bbbc/BBBC039/masks.zip',
]


def download_bbbc039(directory: str):
    """Download and extract BBBC039 (https://bbbc.broadinstitute.org/BBBC039)."""
    from ._dl import download_and_extract
    for url in URLS:
        download_and_extract(url, directory)


def _read_all(directory, filename):
    with open(join(directory, filename)) as f:
        return [i.strip() for i in f.readlines()]


def _load(images_directory, masks_directory, names):
    from imageio.v2 import imread
    images = [imread(join(images_directory, f.replace('.png', '.tif'))) for f in names]
    masks = [imread(join(masks_directory, f)) for f in names]
    labels = [connected_label(m[:, :, 0]) for m in masks]
    return images, masks, labels


class _BBBC039:
    def __init__(self, directory, download, mode: str):
        assert mode in ('train', 'test', 'val')
        if download:
            download_bbbc039(directory)
        self.names = _read_all(join(directory, 'metadata'), {
            'train': 'training.txt', 'val': 'validation.txt', 'test': 'test.txt'}[mode])
        self.images, self.masks, self.labels = _load(join(directory, 'images'),
                                                      join(directory, 'masks'), self.names)

    def __getitem__(self, item):
        return self.names[item], self.images[item], self.masks[item], self.labels[item]

    def __len__(self):
        return len(self.images)


class BBBC039Train(_BBBC039):
    def __init__(self, directory, download=False):
        super().__init__(directory, download=download, mode='train')


class BBBC039Val(_BBBC039):
    def __init__(self, directory, download=False):
        super().__init__(directory, download=download, mode='val')


class BBBC039Test(_BBBC039):
    def __init__(self, directory, download=False):
        super().__init__(directory, download=download, mode='test')
