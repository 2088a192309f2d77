"""Port parity: augmentations and transforms without cv2.

The same images, labels and ``RandomState`` go through the JAX package's
``data.augmentation`` (which calls cv2) and the port's; everything is held
exactly, the elastic warp included (its blur and its remap are bit for bit
cv2's, ``data/_draw.py``):

* each of the nine augmentations at ``p=1`` on grayscale, one-channel and
  RGB float images with channelled int32 labels, and the numbers drawn
  after it (the same draws in the same order);
* ``conf2augmentation`` with the two demos' dicts (and the elastic warp
  added) over a few items, and ``Compose`` on uint8 input;
* ``BasicTransforms`` at each stage;
* the remap (``INTER_LINEAR``/``BORDER_REFLECT`` and
  ``INTER_NEAREST``/``BORDER_CONSTANT``) against ``cv2.remap``, the call
  the JAX package makes, over Hypothesis-drawn sizes, channel counts and
  maps, half-pixel coordinates included.
"""
import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from celldetection_tpu.data import augmentation as jaug
from celldetection_tpu.data import transforms as jtrans
from celldetection_tpu_torch.data import _draw
from celldetection_tpu_torch.data import augmentation as taug
from celldetection_tpu_torch.data import transforms as ttrans
from test_torch_port_cpn import one_torch_thread  # noqa: F401  (pytestmark)
from test_torch_port_toydata import cv2_avx2

pytestmark = pytest.mark.usefixtures('one_torch_thread')

AUGS = [('HorizontalFlip', {}), ('VerticalFlip', {}), ('Transpose', {}), ('RandomRotate90', {}),
        ('RandomBrightnessContrast', {}), ('RandomGamma', {}),
        ('RandomGamma', {'gamma_limit': (80, 120)}),
        ('GaussNoise', {}), ('GaussNoise', {'var_limit': (10, 50)}),
        ('RandomCrop', {'height': 24, 'width': 31}), ('ElasticTransform', {}),
        ('ElasticTransform', {'alpha': 80., 'sigma': 3.})]
BINARY = {'HorizontalFlip': {'p': .5}, 'VerticalFlip': {'p': .5}, 'RandomRotate90': {'p': .5},
          'RandomBrightnessContrast': {'p': .3}}
MULTICLASS = {'Transpose': {'p': 0.5}, 'RandomRotate90': {'p': 0.5}}


def _item(seed, shape):
    rng = np.random.RandomState(seed)
    image = rng.rand(*shape).astype(np.float32)
    labels = np.zeros(shape[:2] + (2,), np.int32)
    for c in range(2):
        for i in range(1, 5):
            y, x = rng.randint(0, shape[0] - 6), rng.randint(0, shape[1] - 6)
            labels[y:y + rng.randint(3, 9), x:x + rng.randint(3, 9), c] = i + 10 * c
    return image, labels


def _same(got, want):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('name, kwargs', [
    pytest.param(n, k, id=f'{n}{i}', marks=cv2_avx2 if n == 'ElasticTransform' else ())
    for i, (n, k) in enumerate(AUGS)])
def test_augmentation_matches_jax(name, kwargs):
    for seed, shape in enumerate(((40, 56), (40, 56, 1), (33, 47, 3))):
        image, labels = _item(seed, shape)
        out = []
        for lib in (jaug, taug):
            rng = np.random.RandomState(100 + seed)
            aug = getattr(lib, name)(p=1., **kwargs)
            res = aug(image.copy(), labels.copy(), rng)
            out.append(res + (rng.rand(),))          # the next draw: the same draws before it
        _same(out[1][:2], out[0][:2])
        assert out[1][2] == out[0][2]
        if name == 'HorizontalFlip':                  # and without labels
            assert taug.HorizontalFlip(p=1.)(image, None, np.random.RandomState(0))[1] is None


@pytest.mark.parametrize('settings_', [BINARY, MULTICLASS,
                                       pytest.param(dict(BINARY, ElasticTransform={'p': .3}),
                                                    marks=cv2_avx2)],
                         ids=['binary', 'multiclass', 'binary_elastic'])
def test_conf2augmentation_matches_jax(settings_):
    jt, tt = jaug.conf2augmentation(settings_), taug.conf2augmentation(settings_)
    assert [type(t).__name__ for t in tt.transforms] == list(settings_)
    rj, rt = np.random.RandomState(3), np.random.RandomState(3)
    for seed in range(8):
        image, labels = _item(seed, (48, 48, 1) if seed % 2 else (48, 48, 3))
        _same(tt(image.copy(), labels.copy(), rt), jt(image.copy(), labels.copy(), rj))
        # uint8 in and out (the multiclass demo's images)
        u8 = (image * 255).astype(np.uint8)
        _same(tt(u8.copy(), labels.copy(), rt), jt(u8.copy(), labels.copy(), rj))
    assert rt.rand() == rj.rand()


def test_compose_keeps_uint8():
    image, labels = _item(0, (32, 32, 3))
    u8 = (image * 255).astype(np.uint8)
    out, lab = taug.Compose([taug.RandomBrightnessContrast(p=1.), taug.GaussNoise(p=1.)])(
        u8, labels, np.random.RandomState(0))
    assert out.dtype == np.uint8 and lab.shape == labels.shape
    assert len(np.unique(out)) > 10          # not flattened to {0, 1}


@pytest.mark.parametrize('stage', ['fit', 'validate', 'test', 'predict'])
def test_basic_transforms_match_jax(stage):
    for seed, (shape, dtype) in enumerate((((40, 50), np.float32), ((40, 50, 1), np.uint8),
                                           ((40, 50, 3), np.float64))):
        image, labels = _item(seed, shape)
        image = (image * 255).astype(dtype) if dtype == np.uint8 else image.astype(dtype) * 3
        out = []
        for lib in (jtrans, ttrans):
            t = lib.BasicTransforms(crop_size=24, rng=np.random.RandomState(seed))
            data = dict(image=image.copy(), extra=seed)
            if stage != 'predict':
                data['labels'] = labels.copy()
            out.append(t(stage, **data))
        assert sorted(out[1]) == sorted(out[0])
        for k, v in out[0].items():
            np.testing.assert_array_equal(out[1][k], v, err_msg=k)
    assert ttrans.Transforms()('fit', image=1) == {'image': 1}


@cv2_avx2
@settings(max_examples=60, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), channels=st.sampled_from([0, 1, 2, 3, 4, 5]),
       scale=st.sampled_from([0.3, 3., 40.]), half=st.booleans(), seed=st.integers(0, 2 ** 31 - 1))
def test_remap_matches_cv2(h, w, channels, scale, half, seed):
    rng = np.random.RandomState(seed)
    shape = (h, w) if channels == 0 else (h, w, channels)
    image = rng.rand(*shape).astype(np.float32)
    map_x = (rng.rand(h, w) * (w + 2 * scale) - scale).astype(np.float32)
    map_y = (rng.rand(h, w) * (h + 2 * scale) - scale).astype(np.float32)
    if half:                                   # coordinates on half and whole pixels
        map_x, map_y = np.round(map_x * 2) / 2, np.round(map_y * 2) / 2
    lin = cv2.remap(image, map_x, map_y, cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT)
    near = cv2.remap(image, map_x, map_y, cv2.INTER_NEAREST, borderMode=cv2.BORDER_CONSTANT,
                     borderValue=0)
    # cv2 returns [h, w] for a one-channel image
    np.testing.assert_array_equal(_draw.remap_linear(image, map_x, map_y).reshape(lin.shape), lin)
    np.testing.assert_array_equal(_draw.remap_nearest(image, map_x, map_y).reshape(near.shape),
                                  near)
