"""Port parity: the datasets (``celldetection_tpu_torch.data.datasets``).

Each dataset of the port reads the same files as the JAX package's and
gives equal items (exact):

* ``SynthTrain``/``SynthVal``/``SynthTest`` at their split seeds;
* ``GenericH5`` on an h5 file written to ``tmp_path``, with a transform;
* ``BBBC038Train``, ``BBBC039Train/Val/Test`` and ``BBBC041Train/Test`` on
  tiny trees of PNG and TIF files (and JSON annotations) in ``tmp_path``;
* ``download_*`` with a local stand-in for ``urlretrieve`` that serves zip
  files from ``tmp_path``: the same files fetched, extracted once, no
  network.
"""
import json
import os
import zipfile

import h5py
import imageio.v2 as imageio
import numpy as np
import pytest

from celldetection_tpu.data import datasets as jds
from celldetection_tpu.data.datasets import _dl as jdl
from celldetection_tpu_torch.data import datasets as tds
from celldetection_tpu_torch.data.datasets import _dl as tdl
from test_torch_port_cpn import one_torch_thread  # noqa: F401  (pytestmark)
from test_torch_port_toydata import cv2_avx2

pytestmark = pytest.mark.usefixtures('one_torch_thread')


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@cv2_avx2
@pytest.mark.parametrize('split', ['SynthTrain', 'SynthVal', 'SynthTest'])
def test_synth_splits_match_jax(split):
    kw = dict(n=3, height=64, width=72, num=6, radius=(5, 9))
    j, t = getattr(jds, split)(**kw), getattr(tds, split)(**kw)
    assert len(t) == len(j) == 3
    for i in range(3):
        _equal(t[i], j[i])


def test_generic_h5_matches_jax(tmp_path):
    fn = str(tmp_path / 'data.h5')
    rng = np.random.RandomState(0)
    with h5py.File(fn, 'w') as h:
        h['images'] = rng.rand(4, 16, 16).astype(np.float32)
        h['labels'] = rng.randint(0, 5, (4, 16, 16)).astype(np.int32)
    for keys, transform in (('images', None), (('images', 'labels'), lambda a, b: (a * 2, b + 1))):
        j, t = jds.GenericH5(fn, keys, transform), tds.GenericH5(fn, keys, transform)
        assert len(t) == len(j) == 4
        for i in range(4):
            _equal(t[i], j[i])


def _bbbc038_tree(root, rng):
    for s in range(3):
        os.makedirs(root / f's{s}' / 'images')
        os.makedirs(root / f's{s}' / 'masks')
        imageio.imwrite(root / f's{s}' / 'images' / f's{s}.png',
                        rng.randint(0, 255, (20, 24, 3)).astype(np.uint8))
        for m in range(1 + s):
            mask = np.zeros((20, 24), np.uint8)
            y, x = rng.randint(0, 14, 2)
            mask[y:y + 5, x:x + 6] = 255
            imageio.imwrite(root / f's{s}' / 'masks' / f'm{m}.png', mask)


def test_bbbc038_matches_jax(tmp_path):
    _bbbc038_tree(tmp_path, np.random.RandomState(1))
    j, t = jds.BBBC038Train(str(tmp_path)), tds.BBBC038Train(str(tmp_path))
    assert len(t) == len(j) == 3
    for i in range(3):
        _equal(t[i], j[i])


def test_bbbc039_matches_jax(tmp_path):
    rng = np.random.RandomState(2)
    for d in ('images', 'masks', 'metadata'):
        os.makedirs(tmp_path / d)
    names = [f'img{i}.png' for i in range(5)]
    for n in names:
        imageio.imwrite(tmp_path / 'images' / n.replace('.png', '.tif'),
                        rng.randint(0, 4000, (18, 22)).astype(np.uint16))
        mask = np.zeros((18, 22, 3), np.uint8)
        mask[2:7, 3:9, 0] = 1
        mask[10:15, 12:20, 0] = 2
        mask[10:15, 2:6, 0] = 2          # the same value apart: two instances
        imageio.imwrite(tmp_path / 'masks' / n, mask)
    for fn, part in (('training.txt', names[:3]), ('validation.txt', names[3:4]),
                     ('test.txt', names[4:])):
        (tmp_path / 'metadata' / fn).write_text('\n'.join(part) + '\n')
    for split, n in (('BBBC039Train', 3), ('BBBC039Val', 1), ('BBBC039Test', 1)):
        j, t = getattr(jds, split)(str(tmp_path)), getattr(tds, split)(str(tmp_path))
        assert len(t) == len(j) == n
        for i in range(n):
            _equal(t[i], j[i])
        assert t[0][3].max() == 3


def test_bbbc041_matches_jax(tmp_path):
    rng = np.random.RandomState(3)
    os.makedirs(tmp_path / 'images')
    items = []
    for i in range(3):
        imageio.imwrite(tmp_path / 'images' / f'{i}.png',
                        rng.randint(0, 255, (16, 20, 3)).astype(np.uint8))
        objects = [{'bounding_box': {'minimum': {'r': 1 + k, 'c': 2},
                                     'maximum': {'r': 9, 'c': 11 + k}},
                    'category': ('ring', 'leukocyte', 'unknown')[k % 3]} for k in range(i + 1)]
        items.append({'image': {'pathname': f'/images/{i}.png'}, 'objects': objects})
    items.append({'image': {'pathname': '/images/0.png'}})            # no objects
    for fn in ('training.json', 'test.json'):
        (tmp_path / fn).write_text(json.dumps(items))
    for split in ('BBBC041Train', 'BBBC041Test'):
        j, t = getattr(jds, split)(str(tmp_path)), getattr(tds, split)(str(tmp_path))
        assert len(t) == len(j) == 4
        for i in range(4):
            _equal(t[i], j[i])


@pytest.mark.parametrize('fn', ['download_bbbc038', 'download_bbbc039', 'download_bbbc041',
                                'download_synth'])
def test_download_with_a_local_urlretrieve(fn, tmp_path, monkeypatch):
    served = tmp_path / 'served.zip'
    with zipfile.ZipFile(served, 'w') as z:
        z.writestr('inside/readme.txt', 'payload')
    fetched = {}

    def stand_in(key):
        def retrieve(url, filename):
            fetched.setdefault(key, []).append(url)
            with open(served, 'rb') as src, open(filename, 'wb') as dst:
                dst.write(src.read())
        return retrieve

    monkeypatch.setattr(jdl, 'urlretrieve', stand_in('jax'))
    monkeypatch.setattr(tdl, 'urlretrieve', stand_in('port'))
    trees = {}
    for key, lib in (('jax', jds), ('port', tds)):
        root = tmp_path / key
        getattr(lib, fn)(str(root))
        getattr(lib, fn)(str(root))                  # the second call fetches nothing
        trees[key] = sorted(os.path.relpath(os.path.join(d, f), root)
                            for d, _, fs in os.walk(root) for f in fs)
    assert fetched['port'] == fetched['jax'] and fetched['port']
    assert trees['port'] == trees['jax']
    assert any(p.endswith(os.path.join('inside', 'readme.txt')) for p in trees['port'])
    assert not any(p.endswith('.part') for p in trees['port'])


def test_segmentation_helpers_match_jax():
    """The rest of ``data/segmentation.py``: the padding helpers, relabelling,
    label stacks, unary masks and boxes (``cv2.rectangle`` in the JAX package)."""
    from celldetection_tpu.data import segmentation as jseg
    from celldetection_tpu_torch.data import segmentation as tseg
    rng = np.random.RandomState(4)
    stack = rng.randint(0, 4, (24, 20, 3)).astype(np.int32)
    stack[:3, :3, 0] = -1
    for padding, preserve in ((0, True), (2, True), (3, False)):
        a, b = stack.copy(), stack.copy()
        jseg.fill_padding_([a], padding, preserve_existing=preserve)
        tseg.fill_padding_([b], padding, preserve_existing=preserve)
        _equal(b, a)
        _equal(tseg.remove_padding([b], padding)[0], jseg.remove_padding([a], padding)[0])
    a, b = stack.copy(), stack.copy()
    jseg.relabel_(a)
    tseg.relabel_(b)
    _equal(b, a)
    gray = rng.randint(0, 3, (16, 18))
    rgb = rng.randint(0, 2, (16, 18, 3)).astype(np.uint8)
    for relabel in (True, False):
        _equal(tseg.stack_labels(gray, rgb, relabel=relabel),
               jseg.stack_labels(gray, rgb, relabel=relabel))
    masks = rng.rand(5, 12, 14) > 0.7
    for transpose in (True, False):
        _equal(tseg.unary_masks2labels(masks, transpose), jseg.unary_masks2labels(masks, transpose))
    boxes = [(2, 3, 9, 7), (-4, 5, 30, 6), (10, -3, 12, 40), (5, 5, 5, 5)]
    _equal(tseg.boxes2masks(boxes, (12, 14)), jseg.boxes2masks(boxes, (12, 14)))
