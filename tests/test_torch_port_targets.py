"""Port parity: the host target pipeline without cv2.

The port's numpy versions of ``cv2.findContours(RETR_EXTERNAL,
CHAIN_APPROX_NONE)`` (``data.cpn.outer_borders`` in ``labels2contours``) and
``cv2.distanceTransform(DIST_L2, 3)`` (``data.cpn.chamfer_distance`` in
``labels2distances``) against the JAX package's cv2-based functions, array
for array and bit for bit, on numpy-seeded label images: disks, ellipses,
touching cells, 1-pixel instances, 1-pixel lines, instances with holes (and
pieces inside them), instances at the image border and fragmented labels
(flagged -1). Then ``cpn_targets_single`` and ``collate_cpn_targets`` (within
1e-6, equal in practice), the committed EFD and label-downsampling fixtures,
and an import of the port's ``data`` package with cv2 and scikit-image
blocked.

OpenCV 5's 3x3 chamfer runs in float32 and is vectorised; the port copies
the forward pass's blocks of four columns, which decide the rounding near
background. Far from any background pixel (beyond some 30 px, in a mask with
few zero pixels) OpenCV's sums still round differently from the port's, by
up to 12 ulp measured; ``test_chamfer_far_from_background_within_16_ulp``
holds that case to 16 ulp and to bit equality within 30 px.
"""
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from celldetection_tpu.data import cpn as jcpn
from celldetection_tpu.data import targets as jtargets
from celldetection_tpu_torch.data import cpn as tcpn
from celldetection_tpu_torch.data import targets as ttargets
from celldetection_tpu_torch.ops.commons import downsample_labels
from conftest import load_fixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _disks(rng, size, num, radius, ellipse=False, touching=False):
    labels = np.zeros((size, size), np.int32)
    yy, xx = np.mgrid[:size, :size]
    for i in range(1, num + 1):
        cy, cx = rng.uniform(0, size, 2)
        ry, rx = rng.uniform(*radius, 2) if ellipse else (rng.uniform(*radius),) * 2
        theta = rng.uniform(0, np.pi)
        dy, dx = yy - cy, xx - cx
        u = dx * np.cos(theta) + dy * np.sin(theta)
        v = -dx * np.sin(theta) + dy * np.cos(theta)
        inside = (u / rx) ** 2 + (v / ry) ** 2 <= 1
        labels[inside & ((labels == 0) | touching)] = i
    return labels


def _case(name):
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == 'disks':
        return _disks(rng, 96, 14, (3, 12))
    if name == 'ellipses':
        return _disks(rng, 96, 12, (2, 14), ellipse=True)
    if name == 'touching':
        return _disks(rng, 64, 30, (5, 10), touching=True)
    if name == 'pixels_and_lines':
        lab = np.zeros((40, 40), np.int32)
        for i in range(1, 9):                          # single pixels
            lab[rng.randint(40), rng.randint(40)] = i
        lab[5, 3:30] = 9                              # 1-px lines, horizontal,
        lab[8:35, 20] = 10                            # vertical
        idx = np.arange(20)
        lab[12 + idx, 2 + idx] = 11                   # and diagonal (8-connected)
        lab[30, 30] = lab[31, 31] = 12                # a diagonal pair
        return lab
    if name == 'holes':
        lab = np.zeros((64, 64), np.int32)
        yy, xx = np.mgrid[:64, :64]
        r = np.hypot(yy - 20, xx - 20)
        lab[(r <= 12) & (r >= 5)] = 1                 # a ring
        lab[(r <= 2)] = 2                             # a cell in its hole
        lab[40:60, 5:25] = 3
        lab[44:56, 9:21] = 0                          # a square frame
        lab[48:52, 13:17] = 3                         # a piece of it in its hole
        lab[35:50, 35:50] = 4
        lab[38:47, 38:47] = 0
        lab[38:47, 38] = 4                            # a 1-px wall into the hole
        lab[10:30, 45:60] = 5
        lab[12:28, 46:59] = 0                         # a frame 1 px thick
        lab[20, 52] = 5                               # a pixel in its hole
        return lab
    if name == 'border':
        lab = _disks(rng, 48, 10, (4, 12))
        lab[0, :10] = 20
        lab[-5:, -3:] = 21
        lab[:, 47] = 22
        return lab
    if name == 'fragmented':
        lab = _disks(rng, 64, 8, (3, 7))
        lab[2:5, 2:5] = 3                             # a second piece of instance 3
        lab[60, 60] = 5
        lab[40:44, 2:4] = 6
        return lab
    raise KeyError(name)


CASES = ['disks', 'ellipses', 'touching', 'pixels_and_lines', 'holes', 'border', 'fragmented']


@pytest.mark.parametrize('name', CASES)
def test_labels2contours_matches_cv2(name):
    labels = _case(name)[..., None]
    want_labels, got_labels = labels.copy(), labels.copy()
    want = jcpn.labels2contours(want_labels, flag_fragmented_inplace=True, raise_fragmented=False)
    got = tcpn.labels2contours(got_labels, flag_fragmented_inplace=True, raise_fragmented=False)
    assert list(got) == list(want) and len(got) > 0
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    np.testing.assert_array_equal(got_labels, want_labels)
    if name == 'fragmented':
        assert (got_labels == -1).any()
        with pytest.raises(ValueError, match='multiple'):
            tcpn.labels2contours(labels.copy())


def test_outer_borders_matches_find_contours_on_random_masks():
    rng = np.random.RandomState(0)
    for _ in range(400):
        h, w = rng.randint(1, 16, 2)
        m = (rng.rand(h, w) < rng.uniform(0.2, 0.95)).astype(np.uint8)
        want = cv2.findContours(m, mode=cv2.RETR_EXTERNAL, method=cv2.CHAIN_APPROX_NONE,
                                offset=(3, 5))[-2]
        got = tcpn.outer_borders(m, offset=(3, 5))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('per_instance', [True, False])
@pytest.mark.parametrize('name', CASES)
def test_labels2distances_matches_cv2(name, per_instance):
    labels = _case(name)[..., None]
    d_want, l_want = jcpn.labels2distances(labels.copy(), per_instance=per_instance)
    d_got, l_got = tcpn.labels2distances(labels.copy(), per_instance=per_instance)
    assert d_got.dtype == d_want.dtype
    np.testing.assert_array_equal(d_got, d_want)
    np.testing.assert_array_equal(l_got, l_want)


def test_chamfer_matches_cv2_on_random_masks():
    rng = np.random.RandomState(1)
    for _ in range(300):
        h, w = rng.randint(1, 40, 2)
        m = (rng.rand(h, w) < rng.uniform(0.3, 1.0)).astype(np.uint8)
        np.testing.assert_array_equal(tcpn.chamfer_distance(m),
                                      cv2.distanceTransform(m, cv2.DIST_L2, 3))
    stack = (rng.rand(5, 23, 31) < 0.8).astype(np.uint8)   # leading axes are images
    np.testing.assert_array_equal(tcpn.chamfer_distance(stack), np.stack(
        [cv2.distanceTransform(s, cv2.DIST_L2, 3) for s in stack]))
    ones = np.ones((4, 9), np.uint8)                       # no background at all
    np.testing.assert_array_equal(tcpn.chamfer_distance(ones),
                                  cv2.distanceTransform(ones, cv2.DIST_L2, 3))


def test_chamfer_far_from_background_within_16_ulp():
    for r, z, w in ((0, 3, 64), (1, 3, 64), (5, 1, 60), (3, 9, 63)):
        m = np.ones((6, w), np.uint8)
        m[r, z] = 0
        want = cv2.distanceTransform(m, cv2.DIST_L2, 3)
        got = tcpn.chamfer_distance(m)
        assert (np.abs(got - want) <= 16 * np.spacing(want)).all()
        near = want < 30            # within 30 px of the zero: bit for bit
        np.testing.assert_array_equal(got[near], want[near])


def _targets_pair(labels, seed, **kw):
    want = jtargets.cpn_targets_single(labels.copy(), 24, 5, rng=np.random.RandomState(seed),
                                       **kw)
    got = ttargets.cpn_targets_single(labels.copy(), 24, 5, rng=np.random.RandomState(seed),
                                      **kw)
    return got, want


@pytest.mark.parametrize('name', ['disks', 'touching', 'holes', 'fragmented'])
def test_cpn_targets_single_matches_jax(name):
    labels = _case(name)
    classes = 1 + np.arange(int(labels.max())) % 3 if name == 'disks' else None
    got, want = _targets_pair(labels, 4, classes=classes)
    assert sorted(got) == sorted(want)
    assert got['num_instances'] == want['num_instances'] > 0
    np.testing.assert_array_equal(got['labels'], want['labels'])
    for k in ('fourier', 'locations', 'sampled_contours', 'hires_sampled_contours', 'sampling',
              'classes'):
        if k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    assert ('classes' in got) == (classes is not None)


def test_collate_cpn_targets_matches_jax():
    items = [_targets_pair(_case(n), i) for i, n in enumerate(['disks', 'ellipses', 'disks'])]
    for max_instances in (None, 40):
        got = ttargets.collate_cpn_targets([g for g, _ in items], max_instances=max_instances)
        want = jtargets.collate_cpn_targets([w for _, w in items], max_instances=max_instances)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match='max_instances'):
        ttargets.collate_cpn_targets([g for g, _ in items], max_instances=2)


def test_cpn_train_item_matches_jax():
    labels = _case('ellipses')
    ds = [(np.zeros((96, 96), np.float32), labels)] * 3
    a = ttargets.CPNTrainItem(ds, 16, 4, seed=3)
    b = jtargets.CPNTrainItem(ds, 16, 4, seed=3)
    for i in range(3):
        for k, v in b[i][1].items():
            np.testing.assert_allclose(a[i][1][k], v, rtol=0, atol=1e-6, err_msg=k)


def test_efd_fixture():
    fx = load_fixture('efd.npz')
    coeffs, loc = tcpn.efd(fx['contour'], order=6)
    np.testing.assert_allclose(coeffs, fx['coeffs'], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(loc, fx['location'], rtol=1e-10)
    recon = tcpn.fourier2contour(fx['coeffs'], fx['location'], samples=64)
    np.testing.assert_allclose(recon, fx['recon'], rtol=1e-10)


def test_downsample_labels_fixture():
    fx = load_fixture('downsample_labels.npz')
    x = torch.from_numpy(np.moveaxis(fx['labels'], 1, -1).copy())   # NCHW fixture -> NHWC
    for size, key in ((16, 'out16'), (24, 'out24')):
        out = downsample_labels(x, [size, size]).numpy()
        np.testing.assert_allclose(out, np.moveaxis(fx[key], 1, -1), rtol=1e-6)
    lab = torch.from_numpy(_case('disks')[None])            # [n, h, w] int labels
    out = downsample_labels(lab, (48, 48))
    assert out.dtype == torch.float32 and out.shape == (1, 48, 48)


def test_data_package_imports_without_cv2_and_skimage():
    # nor h5py, imageio or yaml, which the card's machine lacks as well: the
    # toy data, augmentations, transforms, datasets and configs run without them
    code = ('import sys\n'
            'for name in ("cv2", "skimage", "h5py", "imageio", "yaml"):\n'
            '    sys.modules[name] = None\n'
            'import celldetection_tpu_torch.data as d\n'
            'from celldetection_tpu_torch.data import datasets\n'
            'from celldetection_tpu_torch.util import config\n'
            'import numpy as np\n'
            'lab = np.zeros((20, 20), np.int32); lab[5:12, 4:15] = 1\n'
            't = d.cpn_targets_single(lab, 8, 3, rng=np.random.RandomState(0))\n'
            'assert t["num_instances"] == 1\n'
            'image, labels = datasets.SynthTrain(n=1, height=48, width=48, num=4, radius=(5, 8))[0]\n'
            'aug = d.conf2augmentation({"RandomRotate90": {"p": 1}, "ElasticTransform": {"p": 1}})\n'
            'image, labels = aug(image, labels, np.random.RandomState(0))\n'
            'image = d.BasicTransforms(crop_size=32)("fit", image=image, labels=labels)["image"]\n'
            'assert image.shape == (32, 32, 3)\n'
            'assert len(d.random_geometric_shapes(96, 96, seed=0)[3])\n'
            'c = config.Config(a=1); assert len(c.hash()) == 32\n'
            'assert "jax" not in sys.modules and "celldetection_tpu" not in sys.modules\n')
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
