"""Port parity: tiled inference (``parallel/tiles.py: TiledInference``, ``tta_inference``),
the auto-tiled ``CPN.forward`` and the ensemble of ``runtime/cpn_inference.py``.

A tiny CpnU22 (base 8, 64^2 tiles at stride 48, as ``tests/test_parallel.py``
builds it) gets the same numpy-seeded weights in the JAX package and in the
port (``state_dict_from_jax``); both run the same mosaic on the CPU. The score
threshold sits in a wide gap of the scores of every tile, so fp32 rounding
cannot move a pixel across it. Gates: equal ``num_tiles``, ``num_valid`` and
``overflow``; the kept detections matched one to one by box IoU above 0.9;
their contours within 0.1 px on the mean (the refinement rounds coordinates
to pixels, and a point on a .5 boundary may round the other way) and their
scores within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celldetection_tpu import models as jmodels
from celldetection_tpu.ops.boxes import box_iou
from celldetection_tpu.parallel import TiledInference as JaxTiled
from celldetection_tpu.parallel.tiles import tile_image, tta_inference as jax_tta
from celldetection_tpu.runtime.cpn_inference import _ensemble as jax_ensemble
from celldetection_tpu_torch import models as tmodels
from celldetection_tpu_torch.parallel import TiledInference, tta_inference
from celldetection_tpu_torch.runtime.cpn_inference import _ensemble
from celldetection_tpu_torch.util import init_jax_variables, state_dict_from_jax
from test_torch_port_cpn import one_torch_thread  # noqa: F401  (pytestmark)

pytestmark = pytest.mark.usefixtures('one_torch_thread')

TILE, STRIDE = 64, 48


def make_models(seed, capacity=128, **kw):
    """The port's model and the JAX package's, on the same seeded weights."""
    kw = dict(in_channels=1, max_detections=capacity, samples=8,
              backbone_kwargs=dict(base_channels=8), **kw)
    pm = tmodels.CpnU22(device='cpu', **kw)
    variables = init_jax_variables(pm, seed)
    # smaller score logits: random weights saturate the sigmoids otherwise
    score_out = variables['params']['score_head']['conv1']
    score_out.update({k: v * np.float32(0.25) for k, v in score_out.items()})
    pm.load_state_dict(state_dict_from_jax(variables), strict=True)
    jm = jmodels.CpnU22(**kw)
    jm.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    return pm, jm


def threshold_in_gap(jm, image, lo, hi):
    """A threshold in the widest gap of the tiles' sorted probabilities that
    leaves between ``lo`` and ``hi`` foreground pixels in every tile."""
    tiles = tile_image(image, TILE, STRIDE)[0]
    logits = np.asarray(jm.core.apply(jm.variables, jnp.asarray(tiles), False)['scores'])
    per_tile = np.sort(1 / (1 + np.exp(-logits.reshape(len(tiles), -1).astype(np.float64))), 1)
    s = np.unique(per_tile)[::-1]
    mids, gaps = (s[:-1] + s[1:]) / 2, s[:-1] - s[1:]
    counts = np.stack([p.size - np.searchsorted(p, mids, side='right') for p in per_tile])
    ok = ((counts >= lo) & (counts <= hi)).all(0)
    assert ok.any(), 'no threshold leaves lo..hi pixels in every tile'
    i = int(np.argmax(np.where(ok, gaps, -1.)))
    assert gaps[i] > 1e-5, gaps[i]
    return float(mids[i])


def assert_same_detections(got, want, counts=True):
    if counts:
        for key in ('num_tiles', 'num_valid', 'overflow'):
            assert got[key] == want[key], (key, got[key], want[key])
    n = len(want['boxes'])
    assert len(got['boxes']) == n and n > 0
    iou = np.asarray(box_iou(jnp.asarray(want['boxes']), jnp.asarray(got['boxes'])))
    match = iou.argmax(1)
    assert sorted(match.tolist()) == list(range(n)), 'not a one-to-one match'
    assert (iou[np.arange(n), match] > 0.9).all()
    assert np.abs(got['contours'][match] - want['contours']).mean() < 0.1
    np.testing.assert_allclose(got['scores'][match], want['scores'], atol=1e-5)
    np.testing.assert_array_equal(got['classes'][match], want['classes'])
    for key in ('locations', 'fourier'):
        np.testing.assert_allclose(got[key][match], want[key], rtol=1e-3, atol=1e-3)


@pytest.fixture(scope='module')
def setup():
    pm, jm = make_models(0)
    image = np.random.RandomState(0).rand(150, 170).astype(np.float32)
    thresh = threshold_in_gap(jm, image, 10, 100)
    return pm, jm, image, thresh


@pytest.fixture(scope='module')
def jax_tiled(setup):
    """One JAX TiledInference for the default settings: it compiles once."""
    return JaxTiled(setup[1], tile_size=TILE, stride=STRIDE)


@pytest.mark.parametrize('rule', ['nms', 'nms,ex_br'])
def test_tiled_inference_matches_jax(setup, jax_tiled, rule):
    pm, jm, image, thresh = setup
    jt = jax_tiled if rule == 'nms' else JaxTiled(jm, tile_size=TILE, stride=STRIDE,
                                                  stitching_rule=rule)
    want = jt(image, score_thresh=thresh)
    tiled = TiledInference(pm, tile_size=TILE, stride=STRIDE, stitching_rule=rule, batch_size=5)
    got = tiled(image, score_thresh=thresh)
    assert_same_detections(got, want)
    assert got['num_tiles'] == 12 and not got['overflow']
    assert got['contours'][..., 0].max() < 170 and got['contours'][..., 1].max() < 150
    stats = tiled.stats
    assert stats['retried_tiles'] == 0 and stats['attempts'] == 1
    assert [p['name'] for p in stats['nms']] == ['exact'] and stats['nms'][0]['m'] == 12 * 128
    for key in ('forward_ms', 'retry_ms', 'stitch_ms', 'readback_ms', 'total_ms'):
        assert stats[key] >= 0


def masks(shape):
    mask = np.zeros(shape, np.float32)
    mask[:80, :90] = 1.
    points = np.zeros(shape, np.float32)
    points[20:36, 20:36] = 1.
    points[100:116, 120:136] = 1.
    return mask, points


@pytest.mark.parametrize('case', ['mask', 'point_mask', 'exclusive', 'both'])
def test_tiled_inference_with_masks_matches_jax(setup, jax_tiled, case):
    """Score bounds at the tiles' resolution, resized (antialiased) to the
    score map; tiles whose crop of a mask is empty are skipped."""
    pm, jm, image, thresh = setup
    mask, points = masks(image.shape)
    kw = dict(mask=dict(mask=mask), point_mask=dict(point_mask=points),
              exclusive=dict(point_mask=points, point_mask_exclusive=True),
              both=dict(mask=mask, point_mask=points))[case]
    want = jax_tiled(image, score_thresh=thresh, **kw)
    got = TiledInference(pm, tile_size=TILE, stride=STRIDE)(image, score_thresh=thresh, **kw)
    assert_same_detections(got, want)
    assert got['num_tiles'] == {'mask': 4, 'point_mask': 5, 'exclusive': 5, 'both': 1}[case]


def test_empty_mask_skips_every_tile(setup):
    pm, _, image, thresh = setup
    got = TiledInference(pm, tile_size=TILE, stride=STRIDE)(image, mask=np.zeros_like(image))
    assert got['num_tiles'] == 0 and got['num_valid'] == 0 and not got['overflow']
    assert got['contours'].shape == (0, 8, 2) and got['fourier'].shape == (0, 5, 4)


def test_capacity_retry_matches_jax(setup):
    """Tiles with more foreground pixels than K = 16 re-run at 32, 64, ...;
    their wider rows go after the others, which decides score ties."""
    _, _, image, thresh = setup
    pm, jm = make_models(0, capacity=16)
    want = JaxTiled(jm, tile_size=TILE, stride=STRIDE)(image, score_thresh=thresh)
    tiled = TiledInference(pm, tile_size=TILE, stride=STRIDE, batch_size=4)
    got = tiled(image, score_thresh=thresh)
    assert_same_detections(got, want)
    assert tiled.stats['retried_tiles'] > 0 and not got['overflow']
    big = TiledInference(make_models(0)[0], tile_size=TILE, stride=STRIDE)(image,
                                                                          score_thresh=thresh)
    assert got['num_valid'] == big['num_valid']
    off = TiledInference(pm, tile_size=TILE, stride=STRIDE, retry_overflow=False)(
        image, score_thresh=thresh)
    assert off['overflow'] and off['num_valid'] <= got['num_valid']


@pytest.mark.parametrize('case', ['caps', 'survivors'])
def test_stitch_retries_match_jax(setup, case):
    """Saturated output and candidate caps double; a saturated survivor
    buffer of the chunked NMS re-runs at 'full'."""
    pm, jm, image, thresh = setup
    kw = (dict(max_outputs=8, max_candidates=16) if case == 'caps'
          else dict(nms_chunk=4, nms_tile=4))
    want = JaxTiled(jm, tile_size=TILE, stride=STRIDE, **kw)(image, score_thresh=thresh)
    tiled = TiledInference(pm, tile_size=TILE, stride=STRIDE, **kw)
    got = tiled(image, score_thresh=thresh)
    assert_same_detections(got, want)
    assert tiled.stats['attempts'] > 1 and not got['overflow']
    if case == 'survivors':
        names = [p['name'] for p in tiled.stats['nms']]
        assert names.count('cross-chunk') == tiled.stats['attempts']
        first, last = (p for p in tiled.stats['nms'] if p['name'] == 'survivors')
        assert first['count'] > first['cap'] and last['cap'] >= last['count']


def test_tta_inference_matches_jax(setup, jax_tiled):
    pm, jm, image, thresh = setup
    want = jax_tta(jax_tiled, image, reps=4, score_thresh=thresh)
    got = tta_inference(TiledInference(pm, tile_size=TILE, stride=STRIDE), image, reps=4,
                        score_thresh=thresh)
    assert got['num_tiles'] == want['num_tiles'] == 48
    assert_same_detections(got, want, counts=False)


def test_ensemble_matches_jax(setup):
    """Two models' detections, box voting, one NMS; the models' own threshold."""
    _, _, image, thresh = setup
    (pm, jm), (pm2, jm2) = make_models(0), make_models(1)
    for m in (pm, jm, pm2, jm2):
        m.score_thresh = thresh
    # two models; one model twice, whose boxes each get a vote of 2 from their twins
    for (ja, jb, pa, pb), min_vote, reps in (((jm, jm2, pm, pm2), 1, 1), ((jm, jm, pm, pm), 2, 2)):
        jt = {id(m): JaxTiled(m, tile_size=TILE, stride=STRIDE) for m in (ja, jb)}  # one compile
        want = jax_ensemble([jt[id(ja)], jt[id(jb)]], image, None, None, min_vote, 0.2, reps=reps)
        got = _ensemble([TiledInference(m, tile_size=TILE, stride=STRIDE) for m in (pa, pb)],
                        image, None, None, min_vote, 0.2, reps=reps)
        assert got['num_tiles'] == want['num_tiles']
        assert_same_detections(got, want, counts=False)


def test_model_call_above_max_imsize_is_tiled(setup):
    """``model(image)`` above ``max_imsize``: tiled, global coordinates, the
    JAX package's schema (one array per key, ``fg_overflow`` one flag)."""
    _, _, image, thresh = setup
    pm, jm = make_models(0, max_imsize=100, tile_size=TILE, tile_stride=STRIDE)
    want = jm(image[..., None], score_thresh=thresh)
    got = pm(image[..., None], score_thresh=thresh)
    assert sorted(got) == sorted(want)
    assert got['fg_overflow'] == want['fg_overflow'] and got['num_tiles'] == 12
    assert got['contour_proposals'] is None and got['box_uncertainties'] is None
    assert_same_detections({k: v[0] if isinstance(v, list) else v for k, v in got.items()},
                           {k: v[0] if isinstance(v, list) else v for k, v in want.items()},
                           counts=False)
    with pytest.raises(ValueError, match='single image'):
        pm(np.stack([image, image])[..., None], score_thresh=thresh)


class _OomAbove:
    """Wraps a model: its forward raises the CUDA out-of-memory error for
    batches larger than ``limit``, or another error where ``other``."""

    def __init__(self, model, limit, other=False):
        self.model, self.limit, self.other = model, limit, other

    def __getattr__(self, name):
        return getattr(self.model, name)

    def forward_padded(self, tiles, **kw):
        if tiles.shape[0] > self.limit:
            if self.other:
                raise RuntimeError('not a memory error')
            raise torch.cuda.OutOfMemoryError('CUDA out of memory (simulated)')
        return self.model.forward_padded(tiles, **kw)


def test_out_of_memory_halves_the_batch(setup):
    pm, _, image, thresh = setup
    want = TiledInference(pm, tile_size=TILE, stride=STRIDE)(image, score_thresh=thresh)
    tiled = TiledInference(_OomAbove(pm, 3), tile_size=TILE, stride=STRIDE, batch_size=8)
    got = tiled(image, score_thresh=thresh)
    assert tiled.batch_size == 2
    assert_same_detections(got, want)
    with pytest.raises(RuntimeError, match='not a memory error'):
        TiledInference(_OomAbove(pm, 3, other=True), tile_size=TILE, stride=STRIDE,
                       batch_size=8)(image, score_thresh=thresh)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        TiledInference(_OomAbove(pm, 0), tile_size=TILE, stride=STRIDE)(image,
                                                                        score_thresh=thresh)
