"""Port parity: figures, metrics logging, the trainer's logs and the CLI's demo figure.

The same matplotlib (``Agg``) draws both packages' figures, so each plotting
function of ``celldetection_tpu_torch.visualization`` must give the JAX
package's RGBA array (``figure2img``) exactly from the same inputs; the port
is given tensors where the JAX package gets numpy arrays. The colour maps
(cv2's ``HSV2RGB`` in the JAX package, the port's numpy conversion) are
equal byte for byte where cv2 dispatches AVX2. ``MetricsLogger`` writes the same JSON lines (``time``
aside), and with ``tensorboard=True`` an event file. ``CPNTrainer.fit`` of a
tiny CpnU22 in both packages with a logger and ``log_figures_every=1`` logs
the same keys and steps, losses under ``test_torch_port_train.py``'s gate
(the first within 1e-5, the later ones within 1e-2), and writes one PNG a
step. The CLI's ``demo_figure`` writes ``<name>_demo.png``, which equals the
JAX package's figure of the port's detections exactly and the JAX package's
own PNG but for the pixels under contour points that differ by up to
1e-3 px.
"""
import importlib
import json
import os
import subprocess
import sys

import cv2
import flax
import matplotlib
import numpy as np
import optax
import pytest
import torch

matplotlib.use('Agg')
import matplotlib.pyplot as plt  # noqa: E402

from celldetection_tpu.runtime.trainer import CPNTrainer as JTrainer  # noqa: E402
from celldetection_tpu.util import logging as jlogging  # noqa: E402
from celldetection_tpu.visualization import cmaps as jcmaps  # noqa: E402
from celldetection_tpu.visualization import images as jimages  # noqa: E402
from celldetection_tpu_torch.models.commons import Dropout2d  # noqa: E402
from celldetection_tpu_torch.runtime.trainer import CPNTrainer as TTrainer  # noqa: E402
from celldetection_tpu_torch.util import logging as tlogging  # noqa: E402
from celldetection_tpu_torch.visualization import cmaps as tcmaps  # noqa: E402
from celldetection_tpu_torch.visualization import images as timages  # noqa: E402
from test_torch_port_cpn import one_torch_thread  # noqa: F401,E402  (pytestmark)
from test_torch_port_train import SAMPLES, _dataset, _models  # noqa: E402

jcli = importlib.import_module('celldetection_tpu.runtime.cpn_inference')
tcli = importlib.import_module('celldetection_tpu_torch.runtime.cpn_inference')

pytestmark = pytest.mark.usefixtures('one_torch_thread')


@pytest.fixture(autouse=True)
def close_figures():
    yield
    plt.close('all')


def _tensor(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _figure_of(obj):
    return obj if isinstance(obj, matplotlib.figure.Figure) else obj.figure


@pytest.mark.skipif(not cv2.checkHardwareSupport(11),       # cv::CPU_AVX2
                    reason='cv2 dispatches no AVX2 on this CPU: its HSV2RGB vector loop takes '
                           'another number of pixels')
def test_cmaps_match_jax():
    """cv2 converts the colours as one row: 32 pixels at a time by its vector
    loop, the rest one by one (the counts 40, 64, 5 and 100 take both)."""
    for n in (5, 64, 100):
        assert tcmaps.random_colors_hsv(n, seed=n) == jcmaps.random_colors_hsv(n, seed=n)
    for seed in (0, 1, 7):
        for kw in ({}, dict(ubyte=False), dict(hue_range=(10, 20), value_range=(30, 256))):
            assert tcmaps.random_colors_hsv(40, seed=seed, **kw) == \
                jcmaps.random_colors_hsv(40, seed=seed, **kw)
    labels = np.random.RandomState(0).randint(0, 30, (40, 50, 2))
    for lab in (labels, labels[..., 0]):
        want = jcmaps.label_cmap(lab, seed=3)
        got = tcmaps.label_cmap(torch.from_numpy(lab), seed=3)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _scene(seed=0):
    rng = np.random.RandomState(seed)
    image = rng.rand(64, 80).astype(np.float32)
    t = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    centres = rng.uniform(10, 60, (5, 2))
    contours = (centres[:, None] + rng.uniform(4, 9, (5, 1, 1)) *
                np.stack([np.cos(t), np.sin(t)], -1)).astype(np.float32)
    boxes = np.concatenate([contours.min(1), contours.max(1)], 1)
    scores = rng.rand(5).astype(np.float32)
    return image, contours, boxes, scores, centres.astype(np.float32)


PLOTS = {
    'imshow': lambda m, f, s: m.imshow(f(s[0]), figsize=(4, 3)),
    'imshow_rgb': lambda m, f, s: m.imshow(f(np.stack([s[0]] * 3, -1)), figsize=(4, 3)),
    'imshow_row': lambda m, f, s: m.imshow_row(f(s[0]), f(s[0][::-1]), figsize=(6, 3),
                                               titles=['a', 'b']),
    'imshow_grid': lambda m, f, s: m.imshow_grid([f(s[0])] * 3, cols=2, figsize=(5, 4)),
    'imshow_col': lambda m, f, s: m.imshow_col(f(s[0]), f(s[0].T), figsize=(3, 6)),
    'plot_contours': lambda m, f, s: m.plot_contours([f(c) for c in s[1]], fill=0.2,
                                                     texts=list('abcde')),
    'plot_boxes': lambda m, f, s: m.plot_boxes(f(s[2]), ax=m.imshow(f(s[0]), figsize=(4, 3))),
    'plot_score': lambda m, f, s: m.plot_score(f(s[3]), f(s[4]),
                                               ax=m.imshow(f(s[0]), figsize=(4, 3))),
    'plot_text': lambda m, f, s: m.plot_text('cell', 20., 30.,
                                             ax=m.imshow(f(s[0]), figsize=(4, 3))),
    'plot_mask': lambda m, f, s: m.plot_mask(f(s[0] > .5)),
    'show_detection': lambda m, f, s: m.show_detection(
        image=f(s[0]), contours=[f(c) for c in s[1]], boxes=f(s[2]), scores=f(s[3]),
        locations=f(s[4]), figsize=(5, 4)),
    'show_detection_classes': lambda m, f, s: m.show_detection(
        image=f(s[0]), contours=[f(c) for c in s[1]], scores=f(s[3]),
        classes=f(np.array([1, 2, 1, 3, 2])), class_names={1: 'circle', 2: 'square'},
        figsize=(5, 4)),
    'quiver_plot': lambda m, f, s: m.quiver_plot(f(np.stack([s[0], s[0][::-1]], -1)), stride=6),
    'plot_zstack': lambda m, f, s: m.plot_zstack(f(np.stack([s[0], s[0] ** 2, 1 - s[0]])),
                                                 cols=2, figsize=(5, 4)),
    'plot_zstack_max': lambda m, f, s: m.plot_zstack(f(np.stack([s[0], s[0] ** 2])),
                                                     project='max'),
}


@pytest.mark.parametrize('name', sorted(PLOTS))
def test_plot_matches_jax(name):
    scene = _scene()
    draw = PLOTS[name]
    plt.close('all')
    want = jimages.figure2img(_figure_of(draw(jimages, np.asarray, scene)))
    plt.close('all')
    fig = _figure_of(draw(timages, _tensor, scene))
    got = timages.figure2img(fig)
    assert got.dtype == np.uint8 and got.ndim == 3 and got.shape[-1] == 4
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jimages.figure2img(fig))    # the decoders agree


def test_save_fig_get_axes_and_gif_match_jax(tmp_path):
    scene = _scene(1)
    paths = {}
    for key, m, f in (('jax', jimages, np.asarray), ('port', timages, _tensor)):
        plt.close('all')
        fig = m.imshow_row(f(scene[0]), f(scene[0]), figsize=(4, 2))
        assert len(m.get_axes(fig)) == 2 and len(m.get_axes()) == 2
        paths[key] = str(tmp_path / f'{key}.png')
        m.save_fig(paths[key], fig)
        assert not plt.fignum_exists(fig.number)           # closed
        m.plot_gif(*[f(np.roll(scene[0], 9 * k, 1)) for k in range(3)], fn=str(tmp_path / f'{key}.gif'),
                   interval=100)
    from PIL import Image, ImageSequence
    np.testing.assert_array_equal(np.asarray(Image.open(paths['port'])),
                                  np.asarray(Image.open(paths['jax'])))
    frames = [[np.asarray(fr.convert('RGBA')) for fr in ImageSequence.Iterator(
        Image.open(str(tmp_path / f'{key}.gif')))] for key in ('jax', 'port')]
    assert len(frames[0]) == len(frames[1]) == 3
    for a, b in zip(*frames):
        np.testing.assert_array_equal(b, a)


def test_cuda_tensors_are_moved_to_the_host():
    x = torch.arange(12.).reshape(3, 4)
    np.testing.assert_array_equal(timages.to_host(x), x.numpy())
    np.testing.assert_array_equal(timages.to_host(x.bfloat16()), x.numpy())
    assert timages.to_host([1, 2]).tolist() == [1, 2]
    if torch.cuda.is_available():
        np.testing.assert_array_equal(timages.to_host(x.cuda()), x.numpy())


def _records(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k != 'time'} for line in f]


def test_metrics_logger_and_log_figure_match_jax(tmp_path):
    loggers = {'jax': jlogging.MetricsLogger(str(tmp_path / 'jax'), name='m'),
               'port': tlogging.MetricsLogger(str(tmp_path / 'port'), name='m')}
    for lg in loggers.values():
        for step in range(3):
            lg.log(step, loss=np.float32(1.5 / (step + 1)), ema_loss=torch.tensor(0.25 * step),
                   loss_iou=step)
        lg.close()
    assert os.path.basename(loggers['port'].path) == 'm.jsonl'
    assert _records(loggers['port'].path) == _records(loggers['jax'].path)
    assert list(_records(loggers['port'].path)[0]) == ['step', 'loss', 'ema_loss', 'loss_iou']

    # a figure beside the log, under the JAX package's file name
    for key, mod, m in (('jax', jlogging, jimages), ('port', tlogging, timages)):
        fig = m.imshow(_scene()[0], figsize=(3, 3)).figure
        mod.log_figure(loggers[key], 'val/contours', fig, step=4)
    names = sorted(os.listdir(tmp_path / 'port'))
    assert names == sorted(os.listdir(tmp_path / 'jax')) == ['m.jsonl', 'val_contours_4.png']
    from PIL import Image
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / 'port' / names[1])),
                                  np.asarray(Image.open(tmp_path / 'jax' / names[1])))

    # tensorboard: scalars and an image in an event file
    tb = tlogging.MetricsLogger(str(tmp_path / 'tb'), tensorboard=True)
    assert tb._tb is not None
    tb.log(0, loss=1.)
    tlogging.log_figure(tb._tb, 'fig', timages.imshow(_scene()[0], figsize=(2, 2)).figure, 1)
    tb.close()
    events = [n for n in os.listdir(tmp_path / 'tb') if n.startswith('events.out.tfevents')]
    assert len(events) == 1 and os.path.getsize(tmp_path / 'tb' / events[0]) > 0
    assert _records(tb.path) == [{'step': 0, 'loss': 1.}]


def test_fit_logs_metrics_and_figures_as_jax(tmp_path):
    data = _dataset(4, seed=30)
    pm, jm, _ = _models(seed=4)
    for m in pm.modules():
        if isinstance(m, Dropout2d):
            m.p = 0.

    def no_dropout(call, args, kwargs, context):
        if isinstance(context.module, flax.linen.Dropout):
            return args[0]
        return call(*args, **kwargs)

    logs = {key: mod.MetricsLogger(str(tmp_path / key)) for key, mod in
            (('jax', jlogging), ('port', tlogging))}
    jt = JTrainer(jm, optimizer=optax.adam(1e-3), log_fn=lambda *a: None, seed=5,
                  metrics_logger=logs['jax'], log_figures_every=1)
    messages = []
    tt = TTrainer(pm, optimizer={'Adam': {'lr': 1e-3}}, log_fn=messages.append, seed=5,
                  metrics_logger=logs['port'], log_figures_every=1)
    kw = dict(epochs=1, batch_size=2, max_instances=16, samples=SAMPLES)
    with flax.linen.intercept_methods(no_dropout):
        jt.fit(data, **kw)
    ht = tt.fit(data, **kw)
    want, got = _records(logs['jax'].path), _records(logs['port'].path)
    assert [list(r) for r in got] == [list(r) for r in want]
    assert [r['step'] for r in got] == [r['step'] for r in want] == [1, 2]
    assert set(got[0]) >= {'step', 'loss', 'ema_loss', 'loss_fourier', 'loss_score'}
    np.testing.assert_allclose(got[0]['loss'], want[0]['loss'], rtol=1e-5)
    for g, w in zip(got, want):
        for k in g:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-2, atol=1e-6, err_msg=k)
    assert got[-1]['loss'] == ht[-1]['loss'] and got[-1]['ema_loss'] == ht[-1]['ema_loss']
    assert not [m for m in messages if 'figure' in m], messages
    for key in ('jax', 'port'):
        pngs = sorted(n for n in os.listdir(tmp_path / key) if n.endswith('.png'))
        assert pngs == ['contours_step1.png', 'contours_step2.png'], (key, pngs)
        for n in pngs:
            assert os.path.getsize(tmp_path / key / n) > 1000
    assert not pm.training


def test_figure_failure_does_not_stop_training(tmp_path, monkeypatch):
    pm, _, _ = _models(seed=2)
    messages = []
    tt = TTrainer(pm, log_fn=messages.append, seed=1, log_figures_every=1,
                  metrics_logger=tlogging.MetricsLogger(str(tmp_path)))

    def broken(*args, **kwargs):
        raise RuntimeError('no display')
    monkeypatch.setattr(timages, 'show_detection', broken)
    hist = tt.fit(_dataset(2, seed=3), epochs=1, batch_size=2, max_instances=16,
                  samples=SAMPLES)
    assert np.isfinite(hist[-1]['loss'])
    assert any('figure logging failed: RuntimeError: no display' in m for m in messages)


def test_cli_demo_figure_matches_jax(tmp_path):
    from test_torch_port_cli import STRIDE, TILE, _threshold
    from test_torch_port_tiles import make_models
    pm, jm = make_models(0, capacity=256)
    image = (np.random.RandomState(1).rand(120, 150) * 255).astype(np.uint8)
    thresh = _threshold(jm, image.astype(np.float32)[..., None] / 255., 5, 200)
    kw = dict(tile_size=TILE, stride=STRIDE, score_thresh=thresh, demo_figure=True)
    want = jcli.cpn_inference([image], jm, outputs=str(tmp_path / 'jax'), **kw)
    got = tcli.cpn_inference([image], pm, outputs=str(tmp_path / 'port'), accelerator='cpu',
                             **kw)
    assert len(got[0]['contours']) == len(want[0]['contours']) > 0
    from PIL import Image
    png = np.asarray(Image.open(tmp_path / 'port' / 'array0_demo.png'))
    jpng = np.asarray(Image.open(tmp_path / 'jax' / 'array0_demo.png'))
    # the JAX package's figure of the port's detections: the same pixels
    plt.close('all')
    ax = jimages.show_detection(image=image.astype(np.float32) / 255.,
                                contours=list(got[0]['contours']))
    jimages.save_fig(str(tmp_path / 'same.png'), ax.figure)
    np.testing.assert_array_equal(png, np.asarray(Image.open(tmp_path / 'same.png')))
    # the JAX package's own figure: contour points within 1e-3 px move few pixels
    assert png.shape == jpng.shape
    differ = (png != jpng).any(-1)
    assert differ.mean() < 1e-3, differ.mean()


def test_package_imports_with_matplotlib_and_tensorboard_blocked():
    """The card's machine has neither: the package and its utilities import
    and run without them; a figure names the missing package."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ('import sys\n'
            'for name in ("matplotlib", "tensorboard", "cv2", "imageio", "PIL"):\n'
            '    sys.modules[name] = None\n'
            'import celldetection_tpu_torch as ct\n'
            'import torch, tempfile\n'
            'assert ct.CPNTrainer and ct.TiledInference and ct.cpn_inference and ct.load_model\n'
            'assert ct.__version__ and ct.native and ct.visualization and ct.Tiling\n'
            'with ct.util.Timer(sync=True) as t: pass\n'
            'lg = ct.util.MetricsLogger(tempfile.mkdtemp()); lg.log(1, loss=1.); lg.close()\n'
            'assert ct.visualization.label_cmap(torch.ones(3, 3, dtype=torch.int64)).shape '
            '== (3, 3, 3)\n'
            'try:\n'
            '    ct.visualization.imshow(torch.zeros(3, 3))\n'
            'except ImportError as e:\n'
            '    assert "matplotlib" in str(e)\n'
            'else:\n'
            '    raise AssertionError("imshow ran without matplotlib")\n'
            'bad = {"jax", "celldetection_tpu", "matplotlib", "tensorboard"} & {\n'
            '    m for m, v in sys.modules.items() if v is not None}\n'
            'assert not bad, bad\n')
    res = subprocess.run([sys.executable, '-c', code], cwd=root, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
