"""Synthetic dataset splits, generated with :mod:`..toydata`.

Counterpart of ``celldetection_tpu/data/datasets/synth.py``: the same split
seeds, so the port's items equal the JAX package's.
"""
from ..toydata import random_geometric_objects

__all__ = ['SynthTrain', 'SynthVal', 'SynthTest', 'download_synth']


def download_synth(directory: str, url: str = 'https://celldetection.org/data/synth.zip'):
    """Download and extract the hosted Synth dataset (the generated splits need no download)."""
    from ._dl import download_and_extract
    download_and_extract(url, directory)


class _Synth:
    # bases far apart, so that a large n never reaches another split's seeds
    SEEDS = {'train': 0, 'val': 1 << 28, 'test': 1 << 29}

    def __init__(self, n: int = 32, height: int = 256, width: int = 256, mode: str = 'train',
                 **kwargs):
        base = self.SEEDS[mode]
        self.items = [random_geometric_objects(height, width, seed=base + i, **kwargs)
                      for i in range(n)]

    def __getitem__(self, item):
        image, labels = self.items[item]
        return image, labels

    def __len__(self):
        return len(self.items)


class SynthTrain(_Synth):
    def __init__(self, n=32, **kwargs):
        super().__init__(n=n, mode='train', **kwargs)


class SynthVal(_Synth):
    def __init__(self, n=8, **kwargs):
        super().__init__(n=n, mode='val', **kwargs)


class SynthTest(_Synth):
    def __init__(self, n=8, **kwargs):
        super().__init__(n=n, mode='test', **kwargs)
