"""Port parity: validation (contour rendering, instance matching, the sweep).

The same numpy-seeded contours, labels and images go through the JAX package
(which renders with cv2) and through ``celldetection_tpu_torch`` on the CPU:

* ``render_contour``, ``contours2labels`` and ``resolve_label_channels``
  pixel for pixel against cv2's ``drawContours`` (filled and outlines) and
  ``dilate``, on over 200 seeded contours: self-intersecting polygons and
  figure eights, contours of 1 and 2 points, contours clipped at the border,
  and overlaps that open a third channel; the native rasterizer and its
  fallback bit for bit;
* ``LabelMatcher`` and ``LabelMatcherList``: every property, flat and
  channelled labels, several IoU thresholds, with a ``reduce_fn``;
* ``CPNTrainer.validate``: fed the same contours, the same metrics exactly;
  end to end, the trained fixture CpnU12 on three disk images gives JAX's
  ``best_hparams`` and every metric within 0.02. The metrics are not exact
  because a contour point computed in another order can round to the other
  pixel in ``contours2labels`` and move an instance's IoU;
* ``fit(val_data=, val_every=)`` validates on the right epochs and calibrates.
"""
import os

import numpy as np
import pytest

from celldetection_tpu import models as jmodels
from celldetection_tpu import native as jnative
from celldetection_tpu import util as jutil
from celldetection_tpu.data import cpn as jcpn
from celldetection_tpu.data import instance_eval as jeval
from celldetection_tpu.runtime.trainer import CPNTrainer as JTrainer
from celldetection_tpu_torch import models as tmodels
from celldetection_tpu_torch import native as tnative
from celldetection_tpu_torch.data import cpn as tcpn
from celldetection_tpu_torch.data import instance_eval as teval
from celldetection_tpu_torch.runtime.trainer import CPNTrainer as TTrainer
from celldetection_tpu_torch.util import serialization as tser
from celldetection_tpu_torch.util.weights import init_jax_variables, state_dict_from_jax
from test_torch_port_cpn import one_torch_thread  # noqa: F401  (pytestmark)

pytestmark = pytest.mark.usefixtures('one_torch_thread')

FIXTURE = os.path.join(os.path.dirname(__file__), 'fixtures', 'cpnu12_trained.cdt')
H, W = 96, 80


def random_contours(rng, n, size=(H, W)):
    """Contours of five kinds, in turn: 1 or 2 points, a random (mostly
    self-intersecting) polygon, a wavy closed curve, a circle around a point
    outside the image (clipped at the border) and a figure eight."""
    out = []
    for i in range(n):
        kind = i % 5
        c = rng.uniform(0, 1, 2) * np.array(size[::-1])
        if kind == 0:
            out.append(c + rng.uniform(-3, 3, (rng.randint(1, 3), 2)))
        elif kind == 1:
            out.append(c + rng.uniform(-15, 15, (rng.randint(3, 12), 2)))
        elif kind == 2:
            t = np.linspace(0, 2 * np.pi, 32, endpoint=False)
            r = rng.uniform(4, 14) * (1 + 0.4 * np.sin(rng.randint(2, 6) * t + rng.rand()))
            out.append(c + np.stack([r * np.cos(t), r * np.sin(t)], 1))
        elif kind == 3:
            t = np.linspace(0, 2 * np.pi, 24, endpoint=False)
            e = np.array([rng.choice([-5., size[1] + 5.]), rng.choice([-5., size[0] + 5.])])
            out.append(e + rng.uniform(8, 20) * np.stack([np.cos(t), np.sin(t)], 1))
        else:
            t = np.linspace(0, 2 * np.pi, 40, endpoint=False)
            out.append(c + rng.uniform(5, 15) * np.stack([np.sin(t), np.sin(t) * np.cos(t)], 1))
    return out


def test_render_contour_equals_cv2():
    rng = np.random.RandomState(0)
    for contour in random_contours(rng, 100):
        for rnd in (False, True):
            a, xa, ya = jcpn.render_contour(contour, val=7, round=rnd)
            b, xb, yb = tcpn.render_contour(contour, val=7, round=rnd)
            assert (xa, ya) == (xb, yb)
            np.testing.assert_array_equal(b, a)
    # outlines: cv2.drawContours(thickness > 0), pixel for pixel
    for contour in random_contours(rng, 40):
        for thickness in (1, 2, 3):
            a, xa, ya = jcpn.render_contour(contour, val=7, round=True, thickness=thickness)
            b, xb, yb = tcpn.render_contour(contour, val=7, round=True, thickness=thickness)
            assert (xa, ya) == (xb, yb)
            np.testing.assert_array_equal(b, a)


def test_contours2labels_and_resolve_equal_cv2():
    rng = np.random.RandomState(1)
    depths = []
    for _ in range(5):
        contours = random_contours(rng, 50)
        a = jcpn.contours2labels(contours, (H, W))
        b = tcpn.contours2labels(contours, (H, W))
        assert b.shape == a.shape and b.dtype == a.dtype
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(tcpn.resolve_label_channels(b),
                                      jcpn.resolve_label_channels(a))
        depths.append(a.shape[-1])
    assert min(depths) >= 3
    # the options: unrounded, unclipped inside the image, a minimum overlap, a sort order
    contours = [c for c in random_contours(rng, 60)
                if (c >= 0).all() and (c[:, 0] <= W - 1).all() and (c[:, 1] <= H - 1).all()]
    scores = rng.rand(len(contours))
    kw = dict(rounded=False, clip=False, ioa_thresh=0.5, sort_by=scores, return_indices=True)
    (a, ka), (b, kb) = jcpn.contours2labels(contours, (H, W), **kw), \
        tcpn.contours2labels(contours, (H, W), **kw)
    np.testing.assert_array_equal(b, a)
    assert ka == kb
    np.testing.assert_array_equal(tcpn.resolve_label_channels(b, kernel=(5, 3)),
                                  jcpn.resolve_label_channels(a, kernel=(5, 3)))
    batch = np.stack([c[:5] for c in contours if len(c) >= 5])
    np.testing.assert_array_equal(tcpn.contours2boxes(batch), jcpn.contours2boxes(batch))


def test_native_rasterizer_equals_jax(monkeypatch):
    rng = np.random.RandomState(2)
    contours = random_contours(rng, 120)
    a = jnative.contours2labels_native(contours, (H, W), fallback=False)
    b = tnative.contours2labels_native(contours, (H, W), fallback=False)
    assert b.dtype == a.dtype
    np.testing.assert_array_equal(b, a)

    def no_build():
        raise RuntimeError('g++ failed')

    monkeypatch.setattr(tnative, 'rasterize_library', no_build)
    with pytest.raises(RuntimeError):
        tnative.contours2labels_native(contours, (H, W), fallback=False)
    np.testing.assert_array_equal(
        tnative.contours2labels_native(contours, (H, W)),
        jcpn.resolve_label_channels(jcpn.contours2labels(contours, (H, W))))


_MATCHER = ('true_positives', 'false_positives', 'false_negatives', 'true_positive_labels',
            'false_positive_labels', 'false_negative_labels', 'precision', 'recall', 'f1',
            'jaccard', 'fowlkes_mallows')
_LIST = ('length', 'true_positives', 'false_positives', 'false_negatives', 'f1', 'f1_np',
         'jaccard_np', 'fowlkes_mallows_np', 'avg_f1', 'avg_jaccard', 'avg_fowlkes_mallows',
         'avg_recall', 'avg_precision', 'precision', 'recall', 'iou_thresh')


def _label_pairs(rng):
    """(prediction, target) label images: flat, channelled and mixed."""
    pairs = []
    for i in range(4):
        target = tcpn.contours2labels(random_contours(rng, 12), (H, W))
        pred = tcpn.contours2labels([c + rng.uniform(-2, 2, 2)
                                     for c in random_contours(rng, 10)], (H, W))
        if i % 2:
            target, pred = tcpn.resolve_label_channels(target), pred[..., 0]
        pairs.append((pred, target))
    pairs.append((np.zeros((H, W), np.int32), pairs[0][1]))   # no prediction
    return pairs


@pytest.mark.parametrize('iou', [0.1, 0.5, 0.8])
def test_label_matcher_equals_jax(iou):
    pairs = _label_pairs(np.random.RandomState(3))
    jl = jeval.LabelMatcherList(reduce_fn=lambda v: 2 * v)
    tl = teval.LabelMatcherList(reduce_fn=lambda v: 2 * v)
    for pred, target in pairs:
        jm = jeval.LabelMatcher(pred, target, iou_thresh=iou, zero_division=0)
        tm = teval.LabelMatcher(pred, target, iou_thresh=iou, zero_division=0)
        for name in _MATCHER:
            assert getattr(tm, name) == getattr(jm, name), name
        np.testing.assert_array_equal(tm.ious, jm.ious)
        jl.append(jm)
        tl.append(tm)
    for name in _LIST:
        assert getattr(tl, name) == getattr(jl, name), name
    m, c = teval.matching_labels(pairs[0][0], pairs[0][1])
    mj, cj = jeval.matching_labels(pairs[0][0], pairs[0][1])
    np.testing.assert_array_equal(m, mj)
    np.testing.assert_array_equal(c, cj)


# --- the sweep ------------------------------------------------------------------------------

def _fake_prediction(rng, labels, n_false):
    """Contours of the true instances, moved by up to 1.5 px, and false
    ones; each with a score."""
    contours = list(tcpn.labels2contours(labels).values())
    contours = [c[:, 0].astype(np.float64) + rng.uniform(-1.5, 1.5, 2) for c in contours]
    contours += [c for c in random_contours(rng, n_false) if len(c) > 2]
    return contours, rng.rand(len(contours))


def _disks(n, size, seed, num=8, radius=(6, 12)):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:size, :size]
    out = []
    for _ in range(n):
        labels = np.zeros((size, size), np.int32)
        image = np.zeros((size, size), np.float32)
        for _ in range(num):
            r = rng.randint(*radius)
            cx, cy = rng.randint(r + 1, size - r - 1, 2)
            disk = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
            if (labels[disk] > 0).any():
                continue
            labels[disk] = labels.max() + 1
            image[disk] = 0.4 + 0.5 * rng.rand()
        image += rng.randn(size, size).astype(np.float32) * 0.03
        out.append((np.clip(image, 0, 1)[..., None], labels))
    return out


def test_validate_metrics_exact_on_the_same_contours():
    data = _disks(3, H, seed=5)
    rng = np.random.RandomState(6)
    preds = [_fake_prediction(rng, lab, 6) for _, lab in data]
    for i, (image, _) in enumerate(data):
        image[0, 0, 0] = i          # the image's index, for the stand-in prediction

    def predict(trainer):
        def fn(image, score_thresh=None):
            contours, scores = preds[int(image[0, 0, 0])]
            keep = scores >= score_thresh
            if trainer.model.nms_thresh > 0.3:   # a second hyperparameter moves the result
                keep &= np.arange(len(scores)) % 3 > 0
            return {'contours': np.array([c for c, k in zip(contours, keep) if k], object)}
        return fn

    hparams = {'score_thresh': [0.2, 0.5, 0.8], 'nms_thresh': [0.2, 0.5]}
    pm = tmodels.CpnU12(in_channels=1, device='cpu', backbone_kwargs=dict(base_channels=8))
    jm = jmodels.CpnU12(1, backbone_kwargs=dict(base_channels=8))
    jm.variables = init_jax_variables(pm)
    results = []
    for trainer in (JTrainer(jm, val_hparams=hparams, log_fn=lambda *a: None),
                    TTrainer(pm, val_hparams=hparams, log_fn=lambda *a: None)):
        trainer._predict_single = predict(trainer)
        for fast in (False, True):
            results.append(trainer.validate(data, iou_threshs=(0.3, 0.5, 0.7), fast_labels=fast))
        assert trainer.model.score_thresh == results[-1]['best_hparams']['score_thresh']
        assert trainer.model.nms_thresh == results[-1]['best_hparams']['nms_thresh']
    assert results[2] == results[0] and results[3] == results[1]
    assert 0 < results[0]['f1_np'] < 1
    tr = TTrainer(pm, val_hparams=hparams, log_fn=lambda *a: None)
    tr._predict_single = predict(tr)
    # one process: every item is this rank's and the sums are its own
    assert tr.validate(data, iou_threshs=(0.3, 0.5, 0.7), distributed=True) == results[0]
    pm.score_thresh = 0.1
    summed = tr.validate(data, iou_threshs=(0.3, 0.5, 0.7), reduce_fn=lambda v: v,
                         calibrate=False)
    assert summed == results[2] and pm.score_thresh == 0.1
    assert len(tr.val_results) == 6 and tr.val_results[0]['counts'].shape == (3, 3, 3)


def test_validate_trained_fixture_matches_jax():
    # crowded, dimmed and noisy disks, and a sweep wide enough that the
    # settings part (the fixture is sure of clear disks)
    data = []
    for image, labels in _disks(3, 128, seed=11, num=40, radius=(5, 12)):
        noise = np.random.RandomState(int(labels.max())).randn(*image.shape).astype(np.float32)
        data.append((np.clip(image * 0.6 + noise * 0.08, 0, 1), labels))
    hparams = {'score_thresh': [.02, .5, .995], 'nms_thresh': [.2, .8]}
    # no re-draw of the init: the stored weights replace it
    jm = jutil.load_model(FIXTURE, torch_init=False, input_shape=(1, 128, 128, 1))
    pm = tser.load_model(FIXTURE, device='cpu')
    jt = JTrainer(jm, val_hparams=hparams, log_fn=lambda *a: None)
    tt = TTrainer(pm, val_hparams=hparams, log_fn=lambda *a: None)
    want, got = jt.validate(data), tt.validate(data)
    assert got['best_hparams'] == want['best_hparams']
    assert len({r['metrics']['f1_np'] for r in tt.val_results}) >= 3
    assert pm.score_thresh == jm.score_thresh and pm.nms_thresh == jm.nms_thresh
    assert want['f1_np'] > 0.4, 'the fixture detected too few disks'
    assert set(got) == set(want)
    for key, v in want.items():
        if key != 'best_hparams':
            assert abs(got[key] - v) <= 0.02, (key, got[key], v)


def test_fit_validates_every_other_epoch_and_calibrates():
    pm = tmodels.CpnU12(in_channels=1, device='cpu', max_detections=64, samples=16,
                        backbone_kwargs=dict(base_channels=8))
    pm.load_state_dict(state_dict_from_jax(init_jax_variables(pm, 1)), strict=True)
    tr = TTrainer(pm, val_hparams={'score_thresh': [0.3, 0.6]}, log_fn=lambda *a: None)
    data = _disks(2, 48, seed=8, num=3, radius=(5, 8))
    calls = []
    validate = tr.validate

    def counting(val_data, **kw):
        calls.append(len(tr.history))
        out = validate(val_data, **kw)
        tr.best_hparams = {'score_thresh': 0.6}       # the choice lands on the model
        pm.score_thresh = 0.6
        return out

    tr.validate = counting
    tr.fit(data, epochs=5, batch_size=2, max_instances=8, val_data=data[:1], val_every=2)
    assert calls == [2, 4]
    assert pm.score_thresh == 0.6
    # without the stand-in: the best setting is set on the model
    tr.validate = validate
    pm.score_thresh = 0.45
    best = tr.validate(data[:1])['best_hparams']
    assert pm.score_thresh == best['score_thresh'] in (0.3, 0.6)
