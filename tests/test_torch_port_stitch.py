"""Port parity: the tiling math, the tile filters, the stitch and ``nms_chunked``.

The same numpy-seeded inputs go through the JAX package on the CPU and the
port with CPU tensors (``celldetection_tpu_torch``): ``util/tiling.py``,
``parallel/tiles.py`` (``tile_image``, ``_border_filter``, ``_stitch_filter``,
``stitch_flat``, ``compact_detections``), ``ops/boxes.py`` (``nms_chunked``,
``nms_indices``, box voting, ``remove_small_boxes_mask``), ``ops/cpn.py``
(``remove_border_contours``, ``filter_contours_by_stitching_rule``) and
``runtime/cpn_inference.py: preprocess``. Masks and index sets must be equal;
float outputs equal up to the stated tolerance.

``nms_chunked`` follows the JAX package's branches on a TPU: exact NMS up to
``EXACT_NMS_MAX`` boxes (the Pallas kernel's range there), chunked above. The
JAX package on a CPU has no Pallas kernel and chunks every N above its chunk,
so the exact branch is held against JAX ``nms_padded`` and the chunked one,
with the bound lowered, against JAX ``nms_chunked``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celldetection_tpu.data.misc import normalize_percentile as jax_normalize_percentile
from celldetection_tpu.ops import boxes as jboxes
from celldetection_tpu.ops import cpn as jcpn
from celldetection_tpu.parallel import tiles as jtiles
from celldetection_tpu.runtime.cpn_inference import preprocess as jax_preprocess
from celldetection_tpu.util import tiling as jtiling
from celldetection_tpu_torch.data import normalize_percentile
from celldetection_tpu_torch.kernels import LAUNCHES
from celldetection_tpu_torch.ops import boxes as tboxes
from celldetection_tpu_torch.ops import cpn as tcpn
from celldetection_tpu_torch.parallel import tiles as ttiles
from celldetection_tpu_torch.runtime import preprocess
from celldetection_tpu_torch.util import tiling as ttiling
from test_torch_port_cpn import one_torch_thread  # noqa: F401  (pytestmark)

pytestmark = pytest.mark.usefixtures('one_torch_thread')

KEYS = ('contours', 'boxes', 'scores', 'classes', 'locations', 'fourier')


def crowded_boxes(seed, n, extent, invalid=0.05):
    rng = np.random.RandomState(seed)
    centers = rng.rand(n, 2) * extent
    sizes = rng.rand(n, 2) * 20 + 2
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], -1).astype(np.float32)
    return boxes, rng.rand(n).astype(np.float32), rng.rand(n) > invalid


def t(a):
    return torch.from_numpy(np.asarray(a))


def j(a):
    return jnp.asarray(np.asarray(a))


# -- util/tiling.py, tile_image ---------------------------------------------

@pytest.mark.parametrize('size, crop, stride', [
    ((200, 200), 64, 48), ((130, 97), 64, 48), ((50, 70), 64, 48), ((64, 64), 64, 48),
    ((1000, 700), (256, 200), (192, 150)), ((100, 100), 30, 40)])
def test_tiling_slices_match_jax(size, crop, stride):
    s_j, o_j, shape_j = jtiling.get_tiling_slices(size, crop, stride, return_overlaps=True)
    s_t, o_t, shape_t = ttiling.get_tiling_slices(size, crop, stride, return_overlaps=True)
    assert shape_t == shape_j
    assert list(s_t) == list(s_j) and list(o_t) == list(o_j)
    tj, tt = jtiling.Tiling((32, 32), size, overlap=5), ttiling.Tiling((32, 32), size, overlap=5)
    assert len(tt) == len(tj)
    for i in range(len(tj)):
        a, b = tj[i], tt[i]
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    assert ttiling.calculate_padding(64, 7, 2, 1) == jtiling.calculate_padding(64, 7, 2, 1)


@pytest.mark.parametrize('shape', [(200, 200), (130, 97, 3), (40, 50), (64, 64, 1)])
def test_tile_image_matches_jax(shape):
    """Including a mosaic smaller than a tile (padded) and sizes no multiple of the stride."""
    image = np.random.RandomState(0).rand(*shape).astype(np.float32)
    want, got = jtiles.tile_image(image, 64, 48), ttiles.tile_image(image, 64, 48)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
        assert np.asarray(g).dtype == np.asarray(w).dtype


# -- the tile filters --------------------------------------------------------

def margin_contours(seed, t_count=6, k=40, s=8, ts=64, pad=4):
    """Global contours of tiles at offsets on a 48-px grid, with points placed
    exactly on each margin (local ``pad``, ``ts - pad``) and at the stitch
    rule's stop, and points one fp32 step beside them, before the offset is
    added in fp32 as the decode adds it."""
    rng = np.random.RandomState(seed)
    local = rng.rand(t_count, k, s, 2).astype(np.float32) * (ts - 2 * pad - 2) + pad + 1
    marks = np.float32([pad, ts - pad, ts - 16, ts - 32])
    for i in range(k // 2):
        v = marks[i % 4]
        v = [v, np.nextafter(v, np.float32(0)), np.nextafter(v, np.float32(ts))][i // 4 % 3]
        local[:, i, rng.randint(s), i % 2] = v
    local[:, k - 4:] = ts - 8            # wholly in the bottom-right stop region
    offsets = (rng.randint(0, 5, (t_count, 2)) * 48).astype(np.float32)
    glob = (local + offsets[:, None, None, :]).astype(np.float32)
    borders = rng.rand(t_count, 4) > 0.3
    overlaps = np.float32(rng.choice([0, 16, 32], (t_count, 2, 2)))
    return glob, offsets, borders, overlaps


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_border_and_stitch_filters_match_jax(seed):
    glob, offsets, borders, overlaps = margin_contours(seed)
    want = np.asarray(jtiles._border_filter(j(glob), j(offsets), j(borders), 64, 4))
    got = ttiles._border_filter(t(glob), t(offsets), t(borders), 64, 4).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.size
    want = np.asarray(jtiles._stitch_filter(j(glob), j(offsets), j(overlaps), 64))
    got = ttiles._stitch_filter(t(glob), t(offsets), t(overlaps), 64).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.size


def test_contour_filters_of_ops_match_jax():
    glob, offsets, _, overlaps = margin_contours(3)
    for i in range(len(glob)):
        off = -offsets[i]
        for flags in ((True,) * 4, (True, False, True, False), (False, True, False, True)):
            want = np.asarray(jcpn.remove_border_contours(j(glob[i]), (64, 64), 4, *flags,
                                                          offsets=j(off)))
            got = tcpn.remove_border_contours(t(glob[i]), (64, 64), 4, *flags, offsets=t(off))
            np.testing.assert_array_equal(got.numpy(), want)
        want = np.asarray(jcpn.filter_contours_by_stitching_rule(
            j(glob[i]), (64, 64), j(overlaps[i]), offsets=j(off)))
        got = tcpn.filter_contours_by_stitching_rule(t(glob[i]), (64, 64), t(overlaps[i]),
                                                     offsets=t(off))
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        tcpn.filter_contours_by_stitching_rule(t(glob[0]), (64, 64), t(overlaps[0]), rule='x')


def test_box_helpers_match_jax():
    boxes, scores, valid = crowded_boxes(4, 300, 120.)
    boxes[:5, 2:] = boxes[:5, :2] + 0.5                   # below the minimum size
    np.testing.assert_array_equal(tboxes.remove_small_boxes_mask(t(boxes), 1.).numpy(),
                                  np.asarray(jboxes.remove_small_boxes_mask(j(boxes), 1.)))
    np.testing.assert_allclose(tboxes.box_iou(t(boxes), t(boxes)).numpy(),
                               np.asarray(jboxes.box_iou(j(boxes), j(boxes))), rtol=1e-6, atol=1e-7)
    for mv in (1.5, 2.):   # vote sums within fp32 rounding: a mask flip needs a vote at mv
        want, wv = jboxes.filter_by_box_voting(j(boxes), 0.2, mv, j(valid), return_votes=True)
        got, gv = tboxes.filter_by_box_voting(t(boxes), 0.2, mv, t(valid), return_votes=True)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    order_j, keep_j = jboxes.nms_indices(j(boxes), j(scores), j(valid), 0.3)
    order_t, keep_t = tboxes.nms_indices(t(boxes), t(scores), t(valid), 0.3)
    np.testing.assert_array_equal(order_t.numpy(), np.asarray(order_j))
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))


# -- nms_chunked --------------------------------------------------------------

def test_nms_chunked_exact_branch_matches_jax_nms_padded():
    """n just above the chunk, inside [EXACT_NMS_MIN, EXACT_NMS_MAX]: exact."""
    arrays = crowded_boxes(5, 2100, 300.)
    want = np.asarray(jboxes.nms_padded(*(j(a) for a in arrays), 0.5))
    got, ovf = tboxes.nms_chunked(*(t(a) for a in arrays), 0.5, chunk=2048, return_overflow=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert ovf is False and 0 < want.sum() < arrays[2].sum()
    # below the exact range and above the chunk the TPU chunks: so does the port
    small = tuple(a[:600] for a in arrays)
    np.testing.assert_array_equal(
        tboxes.nms_chunked(*(t(a) for a in small), 0.5, chunk=128, tile=64).numpy(),
        np.asarray(jboxes.nms_chunked(*(j(a) for a in small), 0.5, chunk=128, tile=64)))


@pytest.mark.parametrize('n, chunk, tile, cap', [
    (3000, 500, 64, None), (3000, 256, 64, 512), (2500, 300, 128, 'n'), (700, 64, 32, 96)])
def test_nms_chunked_chunked_branch_matches_jax(monkeypatch, n, chunk, tile, cap):
    """Bound lowered: chunks rounded up to the tile, the batched per-chunk
    pass, the survivor pass over the valid survivors only, the cap's flag."""
    monkeypatch.setattr(tboxes, 'EXACT_NMS_MAX', 0)
    arrays = crowded_boxes(n + chunk, n, 400.)
    cap = n if cap == 'n' else cap
    want, wovf = jboxes.nms_chunked(*(j(a) for a in arrays), 0.5, chunk=chunk, tile=tile,
                                    survivors_cap=cap, return_overflow=True)
    trace = []
    got, ovf = tboxes.nms_chunked(*(t(a) for a in arrays), 0.5, chunk=chunk, tile=tile,
                                  survivors_cap=cap, return_overflow=True, trace=trace)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ovf == bool(wovf)
    names = [p['name'] for p in trace]
    assert names == ['per-chunk', 'survivors', 'cross-chunk']
    chunk_r = chunk + (-chunk) % tile
    assert (trace[0]['batch'], trace[0]['m']) == (-(-n // chunk_r), chunk_r)
    assert trace[2]['m'] == min(trace[1]['count'], trace[1]['cap'])
    assert all(p.get('launches', 0) == 0 for p in trace)     # CPU tensors: no kernel
    if cap == 96:
        assert ovf, 'the survivor cap must overflow here'


def test_kernel_limits_cover_the_stitch():
    """The kernels take 2^20 boxes an image: a 16,384^2 mosaic's 903,168
    candidate rows of 441 tiles; the large layout starts past 262,144."""
    from celldetection_tpu_torch.kernels.nms import MAX_BOXES, large_layout
    assert MAX_BOXES == 2 ** 20 >= 441 * 2048
    assert large_layout(262_145) and not large_layout(262_144)
    assert tboxes.EXACT_NMS_MAX == jboxes._PALLAS_NMS_MAX
    assert tboxes.EXACT_NMS_MIN == jboxes._PALLAS_NMS_MIN


# -- stitch_flat / compact_detections ------------------------------------------

def flat_detections(seed, n, s=8):
    boxes, scores, valid = crowded_boxes(seed, n, 300.)
    rng = np.random.RandomState(seed + 100)
    scores[rng.rand(n) < 0.05] = 0.5                      # ties: the lower index first
    return dict(contours=rng.rand(n, s, 2).astype(np.float32),
                boxes=boxes, scores=scores, classes=np.ones(n, np.int32),
                locations=rng.rand(n, 2).astype(np.float32),
                fourier=rng.rand(n, 3, 4).astype(np.float32), valid=valid)


@pytest.mark.parametrize('case', ['exact', 'compacted', 'survivor_cap', 'full', 'chunked'])
def test_stitch_flat_and_compact_match_jax(monkeypatch, case):
    flat = flat_detections(7, 1800)
    kw = dict(nms_tile=64, nms_chunk=4096)
    if case == 'compacted':
        kw.update(max_candidates=1000)                # fewer than the valid rows
    elif case == 'survivor_cap':
        kw.update(nms_chunk=256, survivors_cap=128)   # the cross-chunk buffer overflows
    elif case == 'full':
        kw.update(nms_chunk=256, survivors_cap='full')
    elif case == 'chunked':
        monkeypatch.setattr(tboxes, 'EXACT_NMS_MAX', 0)
        flat = flat_detections(8, 2600)
        kw.update(nms_chunk=512, max_candidates=2400)
    want = jtiles.stitch_flat({k: j(v) for k, v in flat.items()}, 0.3, **kw)
    got = ttiles.stitch_flat({k: t(v) for k, v in flat.items()}, 0.3, **kw)
    np.testing.assert_array_equal(got['valid'].numpy(), np.asarray(want['valid']))
    assert int(got['num_pre_valid']) == int(want['num_pre_valid'])
    assert got['survivors_overflow'] == bool(want['survivors_overflow'])
    if case == 'survivor_cap':
        assert got['survivors_overflow']
    for key in KEYS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    for max_outputs in (50, 5000):                    # cut, and padded
        cw, cg = jtiles.compact_detections(want, max_outputs), ttiles.compact_detections(got, max_outputs)
        np.testing.assert_array_equal(cg['valid'].numpy(), np.asarray(cw['valid']))
        assert int(cg['num_valid']) == int(cw['num_valid'])
        for key in KEYS:
            np.testing.assert_array_equal(cg[key].numpy(), np.asarray(cw[key]))


def test_stitch_detections_matches_jax():
    flat = flat_detections(9, 6 * 128)
    det = {k: v.reshape((6, 128) + v.shape[1:]) for k, v in flat.items()}
    want = jtiles.stitch_detections({k: j(v) for k, v in det.items()}, 0.3)
    got = ttiles.stitch_detections({k: t(v) for k, v in det.items()}, 0.3)
    np.testing.assert_array_equal(got['valid'].numpy(), np.asarray(want['valid']))


def test_stitch_counts_no_kernel_launch_on_cpu():
    before = LAUNCHES.copy()
    ttiles.stitch_flat({k: t(v) for k, v in flat_detections(10, 600).items()}, 0.3)
    assert LAUNCHES == before


# -- preprocess -----------------------------------------------------------------

@pytest.mark.parametrize('case', ['uint8', 'uint16', 'float_gamma', 'gray_no_rgb'])
def test_preprocess_matches_jax(case):
    rng = np.random.RandomState(11)
    kw = {}
    if case == 'uint8':
        img = (rng.rand(40, 50, 3) * 255).astype(np.uint8)
    elif case == 'uint16':
        img = (rng.rand(40, 50) * 4000).astype(np.uint16)
        kw = dict(contrast=1.2, brightness=0.05)
    elif case == 'float_gamma':
        img = rng.rand(40, 50).astype(np.float32) * 3
        kw = dict(percentile=(1, 98), gamma=0.7)
    else:
        img = rng.rand(40, 50).astype(np.float32)
        kw = dict(to_rgb=False, percentile=99.)
    want, got = jax_preprocess(img, **kw), preprocess(img, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(normalize_percentile(img, 99.5, to_uint8=True, lower=2.),
                                  jax_normalize_percentile(img, 99.5, to_uint8=True, lower=2.))
