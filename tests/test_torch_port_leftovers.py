"""Port parity: the outline rasteriser, the ``ops`` and ``data`` leftovers, the
cv2 outlines and connected components, and ``nms``/``batched_box_nmsi``.

The same numpy-seeded inputs go through the JAX package and
``celldetection_tpu_torch`` on the CPU; integer outputs, pixels and bytes
must be equal, float ops within 1e-6 relative:

* ``ops.draw.draw_contours``: contours that overlap (the last write in
  ``(contour, point, step)`` order wins, as XLA's scatter on the CPU
  applies duplicates), ``valid``, open contours, points at ``.5``
  (``jnp.linspace``'s steps, not ``torch.linspace``'s, round the same) and
  ``draw_contours_`` in place;
* the ``ops/commons.py`` and ``data/misc.py`` leftovers;
* ``masks2labels`` against cv2's ``connectedComponents`` (4 and 8), and the
  outlines of thickness 1 to 4 (``render_contour``, ``draw_contours``,
  ``contours2overlay``) against cv2's ``drawContours`` on thousands of
  random contours, many of which leave the image;
* ``contours2properties``, ``filter_contours_by_intensity`` and
  ``labels2contour_list``;
* ``nms`` and ``batched_box_nmsi`` with tied scores, the chunked branch with
  ``EXACT_NMS_MAX`` lowered to 0 (the JAX package on the CPU chunks above the
  chunk).
"""
import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celldetection_tpu.data import cpn as jcpn
from celldetection_tpu.data import misc as jdmisc
from celldetection_tpu.ops import boxes as jboxes
from celldetection_tpu.ops import commons as jcommons
from celldetection_tpu.ops import draw as jdraw
from celldetection_tpu_torch.data import _draw as tdraw_prims
from celldetection_tpu_torch.data import cpn as tcpn
from celldetection_tpu_torch.data import misc as tdmisc
from celldetection_tpu_torch.ops import boxes as tboxes
from celldetection_tpu_torch.ops import commons as tcommons
from celldetection_tpu_torch.ops import draw as tdraw
from test_torch_port_cpn import one_torch_thread  # noqa: F401  (pytestmark)

pytestmark = pytest.mark.usefixtures('one_torch_thread')


# -- ops/draw.py ---------------------------------------------------------------

def _draw_cases(seed, n_cases):
    """Contours of a few fixed shapes (the JAX package compiles each shape
    once), points on a half-pixel grid, a third of them clustered."""
    rng = np.random.RandomState(seed)
    for i in range(n_cases):
        n, p = ((7, 9), (19, 5), (2, 14))[i % 3]
        con = (rng.rand(n, p, 2) * 90 - 10).astype(np.float32)
        con = np.round(con * 2) / 2
        if i % 3 == 1:
            con = con * np.float32(0.2) + np.float32(30)
        yield rng, con


@pytest.mark.parametrize('dtype', [np.int32, np.float32])
def test_draw_contours_matches_jax(dtype):
    for rng, con in _draw_cases(0, 9):
        canvas = (rng.rand(64, 72) * 5).astype(dtype)
        valid = rng.rand(len(con)) > 0.3
        for kw in ({}, dict(valid=valid), dict(close=False), dict(val=7, steps_per_segment=9),
                   dict(val=rng.rand(len(con)).astype(np.float32) * 9 + 1, valid=valid,
                        steps_per_segment=23)):
            want = np.asarray(jdraw.draw_contours(
                jnp.asarray(canvas), jnp.asarray(con),
                **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}))
            t_kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                    for k, v in kw.items()}
            got = tdraw.draw_contours(torch.from_numpy(canvas), torch.from_numpy(con), **t_kw)
            assert got.dtype == torch.from_numpy(canvas).dtype
            np.testing.assert_array_equal(got.numpy(), want, err_msg=str(kw))


def test_draw_contours_overlap_takes_the_last_write_and_in_place():
    canvas = torch.zeros(16, 16, dtype=torch.int32)
    # three contours over the same segment: the last one wins everywhere
    seg = np.array([[[2., 3.], [12., 3.]]] * 3, np.float32)
    out = tdraw.draw_contours(canvas, torch.from_numpy(seg), close=False)
    assert set(out[3, 2:13].tolist()) == {3} and int(canvas.abs().sum()) == 0
    want = np.asarray(jdraw.draw_contours(jnp.zeros((16, 16), jnp.int32), jnp.asarray(seg),
                                          close=False))
    np.testing.assert_array_equal(out.numpy(), want)
    # an invalid later contour writes nothing, and the in-place form returns its canvas
    same = tdraw.draw_contours_(canvas, torch.from_numpy(seg), valid=torch.tensor([1, 1, 0]) > 0,
                                close=False)
    assert same is canvas and set(canvas[3, 2:13].tolist()) == {2}
    # jnp.linspace's steps: 6 of 16 differ from torch.linspace's by an ulp
    t = tdraw._unit_steps(16, 'cpu').numpy()
    np.testing.assert_array_equal(t, np.asarray(jnp.linspace(0., 1., 16)))
    assert (t != torch.linspace(0, 1, 16).numpy()).sum() == 6


# -- ops/commons.py leftovers ----------------------------------------------------

def test_ops_commons_leftovers_match_jax():
    rng = np.random.RandomState(0)
    v = (rng.randn(3, 40) * 3).astype(np.float32)
    for limits, bins in (((-2, 3), 7), ((0, 1), 4), ((-1., 1.), 12)):
        np.testing.assert_array_equal(tcommons.values2bins(torch.from_numpy(v), limits, bins).numpy(),
                                      np.asarray(jcommons.values2bins(jnp.asarray(v), limits, bins)))
    ims = [rng.rand(2, rng.randint(2, 9), rng.randint(2, 9)).astype(np.float32) for _ in range(3)]
    for dim in (0, 1):
        np.testing.assert_array_equal(
            tcommons.padded_stack2d(*map(torch.from_numpy, ims), dim=dim).numpy(),
            np.asarray(jcommons.padded_stack2d(*map(jnp.asarray, ims), dim=dim)))
    x = rng.rand(4, 8, 12, 6).astype(np.float32)
    np.testing.assert_array_equal(tcommons.split_spatially(torch.from_numpy(x), (4, 3)).numpy(),
                                  np.asarray(jcommons.split_spatially(jnp.asarray(x), (4, 3))))
    for channels, groups in ((1, None), (2, 2), (3, 1), (6, 4)):
        np.testing.assert_allclose(
            tcommons.minibatch_std_layer(torch.from_numpy(x), channels, groups).numpy(),
            np.asarray(jcommons.minibatch_std_layer(jnp.asarray(x), channels, groups)),
            rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        tcommons.strided_upsampling2d(torch.from_numpy(x), 3, 2.).numpy(),
        np.asarray(jcommons.strided_upsampling2d(jnp.asarray(x), 3, 2.)))
    for n, m in ((17, 40), (40, 17), (40, 13), (5, 5), (30, 60), (9, 2)):
        vec = rng.rand(n).astype(np.float32)
        for method in ('linear', 'nearest'):
            np.testing.assert_allclose(
                tcommons.interpolate_vector(torch.from_numpy(vec), m, method).numpy(),
                np.asarray(jcommons.interpolate_vector(jnp.asarray(vec), m, method)),
                rtol=1e-6, atol=1e-7, err_msg=f'{n}->{m} {method}')
    with pytest.raises(ValueError):
        tcommons.interpolate_vector(torch.zeros(4), 8, 'lanczos3')
    for size in ((10, 20), (4, 20), (8, 12), (2, 3, 4)):
        for kw in ({}, dict(constant_values=3.)):
            got, pad = tcommons.pad_to_size(torch.from_numpy(x), size, return_pad=True, **kw)
            want, jpad = jcommons.pad_to_size(jnp.asarray(x), size, return_pad=True, **kw)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert pad == jpad
    for div, nd in ((5, 2), (32, 2), ((3, 7), 2), (4, 3)):
        got, pad = tcommons.pad_to_div(torch.from_numpy(x), div, nd, return_pad=True)
        want, jpad = jcommons.pad_to_div(jnp.asarray(x), div, nd, return_pad=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert pad == jpad
    for keep in (False, True):
        np.testing.assert_allclose(tcommons.spatial_mean(torch.from_numpy(x), keep).numpy(),
                                   np.asarray(jcommons.spatial_mean(jnp.asarray(x), keep)),
                                   rtol=1e-6)


# -- data/misc.py leftovers -----------------------------------------------------

def test_data_misc_leftovers_match_jax():
    rng = np.random.RandomState(1)
    for shape, kw in (((3, 8, 9), {}), ((2, 3, 8, 9), dict(has_batch=True)),
                      ((2, 3, 4, 8, 9), dict(spatial_dims=2))):
        x = rng.rand(*shape)
        np.testing.assert_array_equal(tdmisc.channels_first2channels_last(x, **kw),
                                      jdmisc.channels_first2channels_last(x, **kw))
        np.testing.assert_array_equal(tdmisc.channels_last2channels_first(x, **kw),
                                      jdmisc.channels_last2channels_first(x, **kw))
    x = rng.rand(3, 8, 9)
    for last in (True, False):
        np.testing.assert_array_equal(tdmisc.transpose_spatial(x, last),
                                      jdmisc.transpose_spatial(x, last))
    arrays = [rng.rand(rng.randint(1, 5), rng.randint(1, 5)) for _ in range(4)] + [rng.rand(3)]
    for axis in (0, 1):
        np.testing.assert_array_equal(tdmisc.padding_stack(*arrays, axis=axis),
                                      jdmisc.padding_stack(*arrays, axis=axis))
    np.testing.assert_array_equal(tdmisc.padding_stack(arrays), jdmisc.padding_stack(arrays))
    batch = [{'image': rng.rand(4, rng.randint(2, 6)), 'name': f'n{i}', 'none': None}
             for i in range(3)] + [None]
    got, want = tdmisc.universal_dict_collate_fn(batch), jdmisc.universal_dict_collate_fn(batch)
    assert list(got) == list(want) and got['name'] == want['name'] and got['none'] is None
    np.testing.assert_array_equal(got['image'], want['image'])
    assert tdmisc.universal_dict_collate_fn([None]) == jdmisc.universal_dict_collate_fn([None])
    code = [3, 5, 20, 7, 50, 1]
    for transpose in (True, False):
        np.testing.assert_array_equal(tdmisc.rle2mask(code, (9, 11), transpose=transpose),
                                      jdmisc.rle2mask(code, (9, 11), transpose=transpose))
    img = rng.rand(13, 17, 2)
    for size in ((20, 20), (10, 30), (13, 17, 4)):
        np.testing.assert_array_equal(tdmisc.pad_to_size(img, size), jdmisc.pad_to_size(img, size))
    np.testing.assert_array_equal(tdmisc.pad_to_div(img, 8), jdmisc.pad_to_div(img, 8))
    np.testing.assert_array_equal(tdmisc.pad_to_div(img, (4, 5), constant_values=2),
                                  jdmisc.pad_to_div(img, (4, 5), constant_values=2))
    for fractions, shuffle in (((.5, .3, .2), True), ((.25, .75), False)):
        for a, b in zip(tdmisc.split(37, *fractions, shuffle=shuffle, seed=4),
                        jdmisc.split(37, *fractions, shuffle=shuffle, seed=4)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tdmisc.split(10, .5, .6)
    labels = tcpn.contours2labels([rng.uniform(5, 40, (8, 2)) for _ in range(6)], (48, 48))[..., 0]
    image = rng.rand(48, 48, 3)
    for (ca, ma), (cb, mb) in zip(zip(*tdmisc.labels2crops(labels, image)),
                                  zip(*jdmisc.labels2crops(labels, image))):
        np.testing.assert_array_equal(ca, cb)
        np.testing.assert_array_equal(ma, mb)


# -- cv2's connected components and outlines -------------------------------------

def test_masks2labels_matches_cv2():
    rng = np.random.RandomState(2)
    for t in range(150):
        h, w = rng.randint(1, 40, 2)
        masks = (rng.rand(rng.randint(1, 4), h, w) < rng.uniform(0.1, 0.8)).astype(np.uint8)
        if t % 10 == 0:
            masks[0] = 1
        if t % 10 == 1:
            masks[-1] = 0
        for connectivity in (4, 8):
            for kw in ({}, dict(reduce=None), dict(count=True), dict(label_axis=0, keepdims=False)):
                want = jcpn.masks2labels(masks, connectivity=connectivity, **kw)
                got = tcpn.masks2labels(masks, connectivity=connectivity, **kw)
                if kw.get('count'):
                    assert got[1] == want[1]
                    got, want = got[0], want[0]
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
        # one mask alone: cv2's own numbering
        m = masks[0]
        for connectivity in (4, 8):
            np.testing.assert_array_equal(
                tcpn.masks2labels([m], connectivity=connectivity, reduce=None)[..., 0],
                cv2.connectedComponents(m, connectivity=connectivity)[1])


def _outline_cases(seed, n):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        h, w = rng.randint(3, 60, 2)
        pts = (rng.rand(rng.randint(1, 9), 2) * [w * 1.6, h * 1.6] - [w * .3, h * .3])
        if rng.rand() < 0.2:
            pts = pts * 5 - 100                   # far outside
        yield rng, int(h), int(w), pts.astype(np.int32), int(rng.randint(1, 5))


def test_outlines_match_cv2_pixel_for_pixel():
    """cv2's ``drawContours(thickness=1..4)``: ``LINE_8`` lines, thick lines as
    quads in 16.16 fixed point with round joins, clipped to the image."""
    for rng, h, w, pts, thickness in _outline_cases(3, 3000):
        want = np.zeros((h, w), np.int32)
        cv2.drawContours(want, [pts.reshape(-1, 1, 2)], 0, 7, thickness)
        got = tdraw_prims.polylines(np.zeros((h, w), np.int32), pts, 7, thickness)
        np.testing.assert_array_equal(got, want, err_msg=f'{pts.tolist()} {thickness}')
    for rng, h, w, pts, thickness in _outline_cases(4, 300):
        p1, p2 = tuple(int(v) for v in pts[0]), tuple(int(v) for v in pts[-1])
        want = cv2.line(np.zeros((h, w), np.uint8), p1, p2, 9, thickness)
        np.testing.assert_array_equal(tdraw_prims.line(np.zeros((h, w), np.uint8), p1, p2, 9,
                                                       thickness), want)


def test_render_draw_and_overlay_outlines_match_jax():
    rng = np.random.RandomState(5)
    for t in range(400):
        con = rng.rand(rng.randint(1, 12), 2) * 40 - 5
        for thickness in (1, 2, 3, 4, -1):
            want = jcpn.render_contour(con, val=3, thickness=thickness, round=bool(t % 2))
            got = tcpn.render_contour(con, val=3, thickness=thickness, round=bool(t % 2))
            assert got[1:] == want[1:]
            np.testing.assert_array_equal(got[0], want[0])
    with pytest.raises(ValueError, match='thickness 0'):
        tcpn.render_contour(con, thickness=0)
    for t in range(60):
        cons = rng.rand(rng.randint(1, 6), 9, 2) * 70 - 8
        canvas = (rng.rand(50, 60) * 255).astype(np.uint8)
        for kw in (dict(), dict(thickness=1, val=9), dict(thickness=-1, val=200),
                   dict(thickness=3, contour_idx=0), dict(val=(1, 2, 3), thickness=4),
                   dict(thickness=-1), dict(offset=(3, -2), thickness=2, val=5)):
            want = jcpn.draw_contours(canvas.copy(), cons, **kw)
            got = tcpn.draw_contours(canvas.copy(), cons, **kw)
            assert got.shape == want.shape and got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=str(kw))
        rgb = np.stack([canvas] * 3, -1)
        np.testing.assert_array_equal(tcpn.draw_contours(rgb.copy(), cons, val=7),
                                      jcpn.draw_contours(rgb.copy(), cons, val=7))
    contours = [rng.rand(12, 2) * 50 - 5 for _ in range(20)]
    for thickness in (1, 2, 3, 4):
        np.testing.assert_array_equal(
            tcpn.contours2overlay(contours, (48, 52), thickness=thickness, seed=1),
            jcpn.contours2overlay(contours, (48, 52), thickness=thickness, seed=1))


def test_properties_intensity_and_contour_lists_match_jax():
    rng = np.random.RandomState(6)
    contours = [c + rng.uniform(0, 40, 2) for c in
                (rng.uniform(-6, 6, (rng.randint(3, 14), 2)) for _ in range(15))]
    for props in (('label', 'area', 'bbox', 'centroid'), ('coords',), ('area', 'image')):
        got = tcpn.contours2properties(contours, *props)
        want = jcpn.contours2properties(contours, *props)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            for x, y in zip(a if len(props) > 1 else [a], b if len(props) > 1 else [b]):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    img = (rng.rand(60, 60) * 255).astype(np.float32)
    for kw in ({}, dict(min_intensity=120, max_intensity=None), dict(aggregate='median',
                                                                     max_intensity=130)):
        np.testing.assert_array_equal(tcpn.filter_contours_by_intensity(img, contours, **kw),
                                      jcpn.filter_contours_by_intensity(img, contours, **kw))
    labels = tcpn.contours2labels(contours[:8], (60, 60))
    flat = tcpn.resolve_label_channels(labels)
    for lab in (flat, labels):
        got, want = tcpn.labels2contour_list(lab), jcpn.labels2contour_list(lab)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# -- nms and batched_box_nmsi ----------------------------------------------------

def _boxes(rng, n, extent=300.):
    xy = rng.rand(n, 2).astype(np.float32) * extent
    wh = rng.rand(n, 2).astype(np.float32) * 30 + 4
    scores = np.round(rng.rand(n) * 20).astype(np.float32) / 20      # many ties
    return np.concatenate([xy, xy + wh], 1), scores


def test_nms_matches_jax_with_ties():
    rng = np.random.RandomState(7)
    for n, thresh in ((1, .5), (7, .3), (300, .3), (2500, .5)):
        b, s = _boxes(rng, n, extent=300. if n < 1000 else 900.)
        want = jboxes.nms(jnp.asarray(b), jnp.asarray(s), thresh)
        got = tboxes.nms(torch.from_numpy(b), torch.from_numpy(s), thresh)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tboxes.nms(b, s, thresh, device='cpu'), want)  # numpy
        np.testing.assert_array_equal(tboxes.batched_box_nmsi([b], [s], thresh, device='cpu')[0],
                                      want)


def test_nms_numpy_inputs_default_to_the_card(monkeypatch):
    """Inputs that are not tensors go to the card unless the caller asks for
    the CPU: without a card they raise, as every entry point of the port does."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    b, s = _boxes(np.random.RandomState(9), 5)
    for call in (lambda: tboxes.nms(b, s, .5), lambda: tboxes.batched_box_nmsi([b], [s], .5),
                 lambda: tboxes.nms(torch.from_numpy(b), torch.from_numpy(s), .5,
                                    device='cuda')):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            call()


@pytest.mark.parametrize('batch_size, exact_max', [(None, None), (4096, None), (512, 0)])
def test_batched_box_nmsi_matches_jax(monkeypatch, batch_size, exact_max):
    """Above its chunk, an image of 2048 to 262,144 boxes takes the exact
    sweep in the port (the JAX package's branch on a TPU); the JAX package on
    the CPU chunks it, so the chunked case lowers ``EXACT_NMS_MAX`` to 0."""
    rng = np.random.RandomState(8)
    lists = [_boxes(rng, n, extent=600.) for n in (5, 900, 2600)]
    boxes, scores = [b for b, _ in lists], [s for _, s in lists]
    exact = tboxes.batched_box_nmsi([torch.from_numpy(b) for b in boxes],
                                    [torch.from_numpy(s) for s in scores], 0.4, batch_size)
    if exact_max is not None:
        monkeypatch.setattr(tboxes, 'EXACT_NMS_MAX', exact_max)
    want = jboxes.batched_box_nmsi([jnp.asarray(b) for b in boxes],
                                   [jnp.asarray(s) for s in scores], 0.4, batch_size)
    got = tboxes.batched_box_nmsi([torch.from_numpy(b) for b in boxes],
                                  [torch.from_numpy(s) for s in scores], 0.4, batch_size)
    assert len(got) == len(want) == 3
    for g, w, s in zip(got, want, scores):
        np.testing.assert_array_equal(g, w)
        assert (np.diff(s[g]) <= 0).all()       # descending score order
    whole = tboxes.nms(torch.from_numpy(boxes[2]), torch.from_numpy(scores[2]), 0.4)
    np.testing.assert_array_equal(exact[2], whole)   # exact in the port's own branch
    if exact_max is not None:
        assert len(got[2]) < len(whole)              # the chunked approximation differs
