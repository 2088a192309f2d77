"""Port parity: the batch inference CLI (``runtime/cpn_inference.py``) and
its writers, ``util/io.py``, the property table, the overlay and
``models/inference.py: Inference``.

A tiny CpnU22 (base 8, one channel) gets the same numpy-seeded weights in the
JAX package and in the port, and both packages' ``cpn_inference`` run the
same uint8 mosaic in 96^2 tiles at stride 64 on the CPU (the port with
``accelerator='cpu'``), with a score threshold in a wide gap of every tile's
scores. Gates: the h5 datasets hold the same detections in the same order
(contours and boxes within 1e-3 px, scores within 1e-5, classes equal); the
matched contours round to the same pixels, and then ``labels`` and
``flat_labels`` are equal bit for bit, the CSV equal line by line and the
overlay TIFF equal for the same colour seed (``RandomState(None)`` of both
packages seeded through a patch).
"""
import copy
import importlib
import json
import os
import sys

import cv2
import h5py
import numpy as np
import pytest
import torch
from imageio.v2 import imread, imwrite

from celldetection_tpu.data import cpn as jdata_cpn
from celldetection_tpu.data import misc as jmisc
from celldetection_tpu.parallel.tiles import tile_image
from celldetection_tpu.util import io as jio
from celldetection_tpu.util import serialization as jser
from celldetection_tpu_torch import models as tmodels
from celldetection_tpu_torch.data import cpn as tdata_cpn
from celldetection_tpu_torch.data import misc as tmisc
from celldetection_tpu_torch.models import Inference
from celldetection_tpu_torch.parallel import mesh as tmesh
from celldetection_tpu_torch.util import io as tio
from celldetection_tpu_torch.util import serialization as tser
from test_torch_port_cpn import one_torch_thread  # noqa: F401  (pytestmark)
from test_torch_port_tiles import make_models

jcli = importlib.import_module('celldetection_tpu.runtime.cpn_inference')
tcli = importlib.import_module('celldetection_tpu_torch.runtime.cpn_inference')

pytestmark = pytest.mark.usefixtures('one_torch_thread')

TILE, STRIDE = 96, 64
ALL_OUTPUTS = dict(labels=True, flat_labels=True, properties=['label', 'area', 'centroid', 'bbox'],
                   overlay=True)


def _threshold(jm, image, lo, hi):
    """A threshold in the widest gap of the tiles' sorted probabilities that
    leaves between ``lo`` and ``hi`` foreground pixels in every tile."""
    tiles = tile_image(image, TILE, STRIDE)[0]
    logits = np.asarray(jm.core.apply(jm.variables, tiles, False)['scores'])
    per_tile = np.sort(1 / (1 + np.exp(-logits.reshape(len(tiles), -1).astype(np.float64))), 1)
    s = np.unique(per_tile)[::-1]
    mids, gaps = (s[:-1] + s[1:]) / 2, s[:-1] - s[1:]
    counts = np.stack([p.size - np.searchsorted(p, mids, side='right') for p in per_tile])
    ok = ((counts >= lo) & (counts <= hi)).all(0)
    i = int(np.argmax(np.where(ok, gaps, -1.)))
    assert ok[i] and gaps[i] > 1e-5, gaps[i]
    return float(mids[i])


@pytest.fixture(scope='module')
def setup():
    pm, jm = make_models(0, capacity=256)
    image = (np.random.RandomState(1).rand(200, 230) * 255).astype(np.uint8)
    thresh = _threshold(jm, image.astype(np.float32)[..., None] / 255., 20, 200)
    return pm, jm, image, thresh


@pytest.fixture
def seeded_colours(monkeypatch):
    """``RandomState(None)`` (the CLI's overlay colours) seeded with 0 in both packages."""
    class Seeded(np.random.RandomState):
        def __init__(self, seed=None):
            super().__init__(0 if seed is None else seed)

    monkeypatch.setattr(np.random, 'RandomState', Seeded)


def _run_both(setup, tmp_path, inputs, tag='', jax_model=None, port_model=None, **kw):
    pm, jm, _, thresh = setup
    kw = dict(tile_size=TILE, stride=STRIDE, score_thresh=thresh, **kw)
    jdir, pdir = str(tmp_path / f'jax{tag}'), str(tmp_path / f'port{tag}')
    want = jcli.cpn_inference(inputs, jax_model or jm, outputs=jdir, **kw)
    got = tcli.cpn_inference(inputs, port_model or pm, outputs=pdir, accelerator='cpu', **kw)
    return want, got, jdir, pdir


def _assert_same_h5(jfn, pfn, keys=('labels', 'flat_labels')):
    with h5py.File(jfn, 'r') as hj, h5py.File(pfn, 'r') as hp:
        assert sorted(hj) == sorted(hp)
        assert json.loads(hj.attrs['args']) == json.loads(hp.attrs['args'])
        cj, cp = hj['contours'][()], hp['contours'][()]
        assert cj.shape == cp.shape and len(cj) > 0
        np.testing.assert_allclose(cp, cj, rtol=0, atol=1e-3)
        np.testing.assert_allclose(hp['boxes'][()], hj['boxes'][()], rtol=0, atol=1e-3)
        np.testing.assert_allclose(hp['scores'][()], hj['scores'][()], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(hp['classes'][()], hj['classes'][()])
        # the label images follow from the contours rounded to pixels
        np.testing.assert_array_equal(np.round(cp), np.round(cj))
        for key in keys:
            if key in hj:
                assert hp[key].dtype == hj[key].dtype
                np.testing.assert_array_equal(hp[key][()], hj[key][()], err_msg=key)
        return len(cj)


def _assert_same_files(jdir, pdir, name):
    n = _assert_same_h5(os.path.join(jdir, f'{name}.h5'), os.path.join(pdir, f'{name}.h5'))
    for suffix in ('.csv', '_overlay.tiff'):
        jfn, pfn = (os.path.join(d, name + suffix) for d in (jdir, pdir))
        assert os.path.isfile(jfn) == os.path.isfile(pfn)
        if suffix == '.csv' and os.path.isfile(jfn):
            with open(jfn) as fj, open(pfn) as fp:
                lines = fp.read().splitlines()
                assert lines == fj.read().splitlines() and len(lines) == n + 1
        elif os.path.isfile(jfn):
            np.testing.assert_array_equal(imread(pfn), imread(jfn))
    return n


def test_cli_array_input_matches_jax(setup, tmp_path, seeded_colours):
    image = setup[2]
    want, got, jdir, pdir = _run_both(setup, tmp_path, [image], **ALL_OUTPUTS)
    assert len(want) == len(got) == 1
    assert got[0]['num_tiles'] == want[0]['num_tiles'] == 12
    n = _assert_same_files(jdir, pdir, 'array0')
    overlay = imread(os.path.join(pdir, 'array0_overlay.tiff'))
    assert overlay.shape == (200, 230, 4) and overlay.dtype == np.uint8
    assert n >= 5 and (overlay[..., 3] > 0).mean() > 0.05


def test_cli_file_inputs_match_jax(setup, tmp_path):
    """A PNG file and an h5 dataset named by ``::key`` and by ``inputs_dataset``."""
    image = setup[2]
    png = str(tmp_path / 'mosaic.png')
    imwrite(png, image)
    h5 = str(tmp_path / 'stack.h5')
    jio.to_h5(h5, image=image, other=image[:, ::-1].copy())
    inputs = [png, h5 + '::other', str(tmp_path / 'sta*.h5')]
    want, got, jdir, pdir = _run_both(setup, tmp_path, inputs, labels=True, flat_labels=True)
    assert len(want) == len(got) == 3
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir)) == ['mosaic.h5', 'stack.h5']
    # the last input of a name overwrites the h5 of the same name, in both
    for name in ('mosaic', 'stack'):
        _assert_same_h5(os.path.join(jdir, f'{name}.h5'), os.path.join(pdir, f'{name}.h5'))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a['contours'], b['contours'], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got[0]['scores'], got[2]['scores'])   # same pixels


def test_overlay_multiprocess_matches_jax_and_the_single_process_coverage():
    """Disjoint contours (where instances overlap, the worker that paints
    last wins, which the scheduling decides)."""
    rng = np.random.RandomState(3)
    gy, gx = np.divmod(np.arange(400), 20)
    centers = (np.stack([gx, gy], -1) * 15. + 8 + rng.rand(400, 2))[:, None]
    angles = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    radius = rng.rand(400, 1, 1) * 4 + 2
    contours = centers + radius * np.stack([np.cos(angles), np.sin(angles)], -1)[None]
    got = tdata_cpn.contours2overlay(contours, (305, 310), seed=11, processes=2)
    want = jdata_cpn.contours2overlay(contours, (305, 310), seed=11, processes=2)
    np.testing.assert_array_equal(got, want)
    single = tdata_cpn.contours2overlay(contours, (305, 310), seed=11)
    np.testing.assert_array_equal(single, jdata_cpn.contours2overlay(contours, (305, 310),
                                                                     seed=11))
    np.testing.assert_array_equal(got[..., 3], single[..., 3])
    # colours: the sequential draw from one RandomState, the workers' from a seed each
    seeds = np.random.RandomState(11).randint(0, 2 ** 31, size=400)
    for i in (0, 77, 399):
        x, y = np.round(centers[i, 0]).astype(int)
        assert tuple(got[y, x, :3]) == tdata_cpn._random_rgb(np.random.RandomState(seeds[i]))
    assert len({tuple(c) for c in single[single[..., 3] > 0][:, :3]}) > 200
    colours = [(1, 2, 3), (200, 100, 50, 255)]
    np.testing.assert_array_equal(
        tdata_cpn.contours2overlay(contours[:5], (200, 300), colors=colours),
        jdata_cpn.contours2overlay(contours[:5], (200, 300), colors=colours))
    assert not tdata_cpn.contours2overlay([], (4, 5)).any()


def test_cli_ensemble_and_reps_match_jax(setup, tmp_path):
    pm, jm, image, thresh = setup
    want, got, jdir, pdir = _run_both(setup, tmp_path, [image], tag='ens', min_vote=2,
                                      jax_model=[jm, jm], port_model=[pm, pm])
    n = _assert_same_h5(os.path.join(jdir, 'array0.h5'), os.path.join(pdir, 'array0.h5'))
    assert got[0]['num_tiles'] == 24 and n > 0
    want, got, jdir, pdir = _run_both(setup, tmp_path, [image], tag='reps', reps=2,
                                      flat_labels=True)
    _assert_same_h5(os.path.join(jdir, 'array0.h5'), os.path.join(pdir, 'array0.h5'))
    assert got[0]['num_tiles'] == 24


def test_cli_grayscale_keeps_uint8_and_matches_jax(setup, tmp_path):
    image = setup[2]
    rgb = np.stack([image, image, image], -1)
    want, got, jdir, pdir = _run_both(setup, tmp_path, [rgb], grayscale=True, flat_labels=True)
    _assert_same_h5(os.path.join(jdir, 'array0.h5'), os.path.join(pdir, 'array0.h5'))
    # the /255 branch: the same detections as the gray input itself
    ref = tcli.cpn_inference([image], setup[0], outputs=str(tmp_path / 'gray'), tile_size=TILE,
                             stride=STRIDE, score_thresh=setup[3], accelerator='cpu')
    np.testing.assert_array_equal(got[0]['scores'], ref[0]['scores'])


def test_cli_skip_existing_and_continue_on_exception(setup, tmp_path, capsys):
    pm, _, image, thresh = setup
    png = str(tmp_path / 'a.png')
    imwrite(png, image)
    kw = dict(outputs=str(tmp_path / 'out'), tile_size=TILE, stride=STRIDE, score_thresh=thresh,
              accelerator='cpu')
    assert len(tcli.cpn_inference([png], pm, **kw)) == 1
    assert tcli.cpn_inference([png], pm, skip_existing=True, **kw) == []
    missing = str(tmp_path / 'missing.png')
    with pytest.raises(FileNotFoundError):
        tcli.cpn_inference([missing, png], pm, **kw)
    res = tcli.cpn_inference([missing, png], pm, continue_on_exception=True, **kw)
    assert len(res) == 1 and 'skipping missing' in capsys.readouterr().out


def test_resolve_model_from_files_of_both_packages(setup, tmp_path):
    pm, jm, _, _ = setup
    jfn, pfn = str(tmp_path / 'jax.cdt'), str(tmp_path / 'port.cdt')
    jser.save_model(jfn, jm)
    tser.save_model(pfn, pm)
    spec = 'score_thresh=0.7,samples=12,certainty_thresh=0.25,refinement=false'
    for fn in (jfn, pfn):
        got = tcli.resolve_model(fn, spec, device='cpu')
        want = copy.copy(jm)           # a copy: the overrides set attributes
        want._jit_cache = {}
        want = jcli.resolve_model(want, spec)
        for k in ('score_thresh', 'samples', 'certainty_thresh', 'refinement'):
            assert getattr(got, k) == getattr(want, k) and type(getattr(got, k)) is \
                type(getattr(want, k)), k
        assert got.samples == 12 and got.certainty_thresh == 0.25 and got.refinement is False
        for k, v in pm.state_dict().items():
            torch.testing.assert_close(got.state_dict()[k], v, rtol=0, atol=0, msg=k)
    # JSON model kwargs are overrides of the stored hyperparameters
    res = tcli.cpn_inference([setup[2]], pfn, outputs=str(tmp_path / 'o'), tile_size=TILE,
                             stride=STRIDE, accelerator='cpu', model_kwargs='{"samples": 6}')
    assert res[0]['contours'].shape[1:] == (6, 2)
    assert tcli.resolve_model(pm, None, device='cpu') is pm


def test_main_through_argv(setup, tmp_path, monkeypatch):
    pm, _, image, thresh = setup
    png = str(tmp_path / 'cells.png')
    imwrite(png, image)
    model = str(tmp_path / 'model.cdt')
    tser.save_model(model, pm)
    out = str(tmp_path / 'cli')
    monkeypatch.setattr(sys, 'argv', [
        'cdt-inference-cpn-torch', '-i', png, '-m', model, '-o', out, '--tile_size', str(TILE),
        '--stride', str(STRIDE), '--score_thresh', repr(thresh), '--accelerator', 'cpu',
        '--flat_labels', '-p', 'label', 'area'])
    tcli.main()
    ref = tcli.cpn_inference([png], pm, outputs=str(tmp_path / 'direct'), tile_size=TILE,
                             stride=STRIDE, score_thresh=thresh, accelerator='cpu',
                             flat_labels=True, properties=['label', 'area'])
    got = tio.from_h5(os.path.join(out, 'cells.h5'), 'contours', 'flat_labels')
    np.testing.assert_array_equal(got[0], ref[0]['contours'])
    with open(os.path.join(out, 'cells.csv')) as f:
        assert f.readline().strip() == 'label,area'


def test_unported_settings_raise(setup, tmp_path):
    pm, _, image, _ = setup
    kw = dict(outputs=str(tmp_path / 'x'), tile_size=TILE, stride=STRIDE)
    with pytest.raises(ValueError, match='tpu'):
        tcli.cpn_inference([image], pm, accelerator='tpu', **kw)
    # one process: num_nodes must be its count; devices=2 starts two ranks,
    # one card each, and raises where fewer cards are visible
    with pytest.raises(ValueError, match='num_nodes'):
        tcli.cpn_inference([image], pm, accelerator='cpu', num_nodes=2, **kw)
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match='rank_devices'):
            tcli.cpn_inference([image], pm, devices=2, **kw)
    with pytest.raises(NotImplementedError, match='demo_figure'):
        tcli.cpn_inference([image], pm, accelerator='cpu', demo_figure=True, **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            tcli.cpn_inference([image], pm, **kw)


def test_shard_inputs_by_process_in_one_process(monkeypatch):
    items = list(enumerate('abcde'))
    assert tmesh.get_rank() == 0 and tmesh.get_num_nodes() == 1
    for level in ('job', 'rank', 'node'):
        assert tmesh.shard_inputs_by_process(items, level) == items
    monkeypatch.setenv('SLURM_NODEID', '1')
    monkeypatch.setenv('SLURM_NNODES', '2')
    assert tmesh.shard_inputs_by_process(items, 'node') == items[1::2]
    with pytest.raises(ValueError, match='group_level'):
        tmesh.shard_inputs_by_process(items, 'host')


def test_io_round_trips_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    a, b = rng.rand(5, 4).astype(np.float32), rng.randint(0, 9, (3, 3, 2)).astype(np.int16)
    for writer, reader in ((tio, jio), (jio, tio)):
        fn = str(tmp_path / f'{writer.__name__}.h5')
        writer.to_h5(fn, a=a, b=b, none=None, attributes={'args': '{"x": 1}'})
        writer.to_h5(fn, mode='a', a=a * 2)
        got_a, got_b = reader.from_h5(fn, 'a', 'b')
        np.testing.assert_array_equal(got_a, a * 2)
        np.testing.assert_array_equal(got_b, b)
        assert set(h5py.File(fn, 'r')) == {'a', 'b'}
        np.testing.assert_array_equal(reader.load_image(fn + '::b'), b)
        np.testing.assert_array_equal(reader.load_image(fn, dataset='a'), a * 2)
        fn = str(tmp_path / f'{writer.__name__}-r.h5')
        writer.to_batched_h5(fn, items=[a, a[:2]])
        writer.to_batched_h5(fn, items=[b])
        with h5py.File(fn, 'r') as h:
            assert sorted(h['items']) == ['0', '1', '2']
            np.testing.assert_array_equal(h['items/2'][()], b)
        assert reader.glob_h5_split(str(tmp_path / f'{writer.__name__}')) == \
            [str(tmp_path / writer.__name__)]
        obj = {'a': [1, 2.5], 'b': {'c': 'd'}}
        for ext in ('json', 'yaml'):
            fn = str(tmp_path / f'{writer.__name__}.{ext}')
            getattr(writer, f'to_{ext}')(fn, obj)
            assert getattr(reader, f'from_{ext}')(fn) == obj
    img = rng.randint(0, 255, (6, 7, 3)).astype(np.uint8)
    assert tio.img_to_base64(img) == jio.img_to_base64(img)
    np.testing.assert_array_equal(tio.base64_to_image(jio.image_to_base64(img)), img)
    for writer in (tio, jio):
        fn = str(tmp_path / f'ov{writer is tio}.tiff')
        writer.to_tiff(fn, np.dstack([img, img[..., :1]]))
        np.testing.assert_array_equal(tio.load_image(fn), jio.load_image(fn))
    png = str(tmp_path / 'img.png')
    imwrite(png, img)
    np.testing.assert_array_equal(tio.load_image(png), jio.load_image(png))


def test_io_names_a_missing_package(tmp_path, monkeypatch):
    for module, call in (('h5py', lambda: tio.to_h5(str(tmp_path / 'x.h5'), a=np.zeros(2))),
                         ('yaml', lambda: tio.from_yaml(str(tmp_path / 'x.yaml'))),
                         ('imageio.v2', lambda: tio.load_image(str(tmp_path / 'x.png'))),
                         ('tifffile', lambda: tio.load_image('x.tif', method='tifffile'))):
        monkeypatch.setitem(sys.modules, module, None)
        with pytest.raises(ImportError, match=module.split('.')[0]):
            call()


def test_property_table_csv_matches_pandas(tmp_path):
    rng = np.random.RandomState(5)
    labels = np.zeros((40, 50), np.int32)
    for i in range(1, 9):
        y, x = rng.randint(0, 35), rng.randint(0, 45)
        labels[y:y + rng.randint(1, 6), x:x + rng.randint(1, 6)] = i
    stack = np.stack([labels, np.roll(labels, 3, 0) * (labels == 0)], -1)
    cases = [((labels, 'label', 'area', 'centroid', 'bbox'), {}),
             ((labels, 'label', 'area', 'centroid'), dict(spacing=(0.5, 2.))),
             ((labels, ['label', 'bbox']), dict(separator='_')),
             ((labels, 'label', 'image'), {}),                     # ragged columns
             ((stack, 'label', 'centroid'), {}),
             ((stack, 'label', 'bbox'), dict(iter_channels=False)),
             ((np.zeros((5, 5), np.int32), 'label', 'bbox', 'area'), {})]
    for i, (args, kw) in enumerate(cases):
        jfn, pfn = str(tmp_path / f'j{i}.csv'), str(tmp_path / f'p{i}.csv')
        jmisc.labels2property_table(*args, **kw).to_csv(jfn, index=False)
        table = tmisc.labels2property_table(*args, **kw)
        table.to_csv(pfn)
        with open(jfn) as fj, open(pfn) as fp:
            assert fp.read() == fj.read(), (i, args[1:], kw)
    rows = tmisc.labels2properties(labels, 'label', 'bbox', 'centroid', offset=(2, 3),
                                   spacing=0.5)
    want = jmisc.labels2properties(labels, 'label', 'bbox', 'centroid', offset=(2, 3),
                                   spacing=0.5)
    assert len(rows) == len(want) > 5
    for r, w in zip(rows, want):
        assert r[0] == w[0] and tuple(r[1]) == tuple(w[1])
        np.testing.assert_array_equal(r[2], w[2])
    assert [p.label for p in tmisc.regionprops2d(stack)] == \
        [p.label for p in jmisc.regionprops2d(stack)]


def test_hsv2rgb_matches_cv2_on_every_overlay_colour():
    """Every hue 0-179, saturation 60-255 and value 128-255 the overlay draws,
    through cv2 one pixel at a time (each row of a non-contiguous ``[N, 1, 3]``
    view is one pixel for cv2, as the overlay's 1x1 calls are)."""
    h, s, v = np.meshgrid(np.arange(180), np.arange(60, 256), np.arange(128, 256),
                          indexing='ij')
    hsv = np.stack([h, s, v], -1).reshape(-1, 3).astype(np.uint8)
    rows = np.zeros((len(hsv), 2, 3), np.uint8)
    rows[:, 0] = hsv
    view = rows[:, :1]
    assert not view.flags['C_CONTIGUOUS']
    want = cv2.cvtColor(view, cv2.COLOR_HSV2RGB)[:, 0]
    for i in np.random.RandomState(0).randint(0, len(hsv), 200):
        np.testing.assert_array_equal(cv2.cvtColor(hsv[None, i:i + 1], cv2.COLOR_HSV2RGB)[0, 0],
                                      want[i])
    np.testing.assert_array_equal(tdata_cpn.hsv2rgb_uint8(hsv), want)


def test_inference_amp_scopes_bf16_to_the_call():
    model = tmodels.CpnU22(in_channels=1, device='cpu', backbone_kwargs=dict(base_channels=4),
                           max_detections=16)
    seen = []
    real_forward = model.forward_padded

    def forward_padded(*args, **kwargs):
        seen.append(model.compute_dtype)
        return real_forward(*args, **kwargs)

    model.forward_padded = forward_padded
    x = np.random.RandomState(0).rand(32, 32, 1).astype(np.float32)
    for prev in (None, torch.float32):
        model.compute_dtype = prev
        out = Inference(model, amp=True, transform=lambda a: a * 0.5)(x)
        assert seen[-1] == torch.bfloat16 and model.compute_dtype == prev
        assert len(out['contours']) == 1
    Inference(model)(x)
    assert seen[-1] is None and model.compute_dtype is torch.float32
    model.forward_padded = None          # the call raises: the dtype is restored all the same
    with pytest.raises(TypeError):
        Inference(model, amp=True)(x)
    assert model.compute_dtype is torch.float32
