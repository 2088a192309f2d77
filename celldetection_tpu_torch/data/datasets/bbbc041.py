"""BBBC041 (malaria-infected blood smears, box annotations).

Counterpart of ``celldetection_tpu/data/datasets/bbbc041.py``: the JSON
annotation files give each image's boxes and category labels (images read
with imageio, imported on use).
"""
import json
from os.path import join

import numpy as np

__all__ = ['BBBC041Train', 'BBBC041Test', 'download_bbbc041']

CLASS_NAMES = ['red blood cell', 'leukocyte', 'gametocyte', 'ring', 'trophozoite',
               'schizont', 'difficult']


def download_bbbc041(directory: str,
                     url: str = 'https://data.broadinstitute.org/bbbc/BBBC041/malaria.zip'):
    """Download and extract BBBC041 (https://bbbc.broadinstitute.org/BBBC041)."""
    from ._dl import download_and_extract
    download_and_extract(url, directory)


class _BBBC041:
    def __init__(self, directory: str, json_name: str):
        self.directory = directory
        with open(join(directory, json_name)) as f:
            self.items = json.load(f)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, item):
        from imageio.v2 import imread
        entry = self.items[item]
        path = entry['image']['pathname'].lstrip('/')
        image = imread(join(self.directory, path))
        boxes, classes = [], []
        for obj in entry.get('objects', []):
            bb = obj['bounding_box']
            boxes.append([bb['minimum']['c'], bb['minimum']['r'],
                          bb['maximum']['c'], bb['maximum']['r']])
            name = obj['category']
            classes.append(CLASS_NAMES.index(name) if name in CLASS_NAMES else -1)
        return image, np.asarray(boxes, np.float32).reshape(-1, 4), np.asarray(classes)


class BBBC041Train(_BBBC041):
    def __init__(self, directory):
        super().__init__(directory, 'training.json')


class BBBC041Test(_BBBC041):
    def __init__(self, directory):
        super().__init__(directory, 'test.json')
