"""Port parity: checkpoint I/O and the repairs that came with it.

The same numpy-seeded weights, images and files go through the JAX package on
the CPU and through ``celldetection_tpu_torch`` with ``device='cpu'``, with
narrow models (base width 8, 64^2 inputs):

* initialization: the port's ``torch_init_`` re-draws the UNet and FPN
  decoders' convolutions to ``U(+-sqrt(3 / fan_in))`` with zero biases and
  leaves the encoders and heads at torch's default ``U(+-1 / sqrt(fan_in))``;
  each convolution's scheme equals the JAX package's ``_resolve_scheme`` on
  the matching flax path (the values cannot equal JAX's draws);
* ``CPN.forward(x, targets=)``: the loss and each term within 1e-5 relative
  of JAX's ``CPN.__call__(x, targets=)`` on the same weights (the training
  forward's tolerance in ``test_torch_port_train.py``: a whole forward sums
  its convolutions in another order than JAX), and ``detach`` keeps both;
* ``labels2contours`` and ``labels2distances`` take the JAX positions of
  cv2's ``mode``, ``method`` and ``distance_type``;
* the port's msgpack: the bytes of ``msgpack.packb`` on hypothesis-drawn
  trees, flax's bytes for array trees, and flax's chunked arrays;
* cdt files, reference ``.pt`` and Lightning ``.ckpt`` files, bit for bit in
  both directions; ``fetch_model`` offline;
* trainer checkpoints: a run resumed from a checkpoint equals an
  uninterrupted one bit for bit, and flax reads its weights.
"""
import json
import os
import sys
import zlib

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import given, settings, strategies as st

from celldetection_tpu import data as jdata
from celldetection_tpu import models as jmodels
from celldetection_tpu import util as jutil
from celldetection_tpu.util import init as jinit
from celldetection_tpu.util import serialization as jser
from celldetection_tpu.util.torch_import import load_torch_cd_model as j_load_torch
from celldetection_tpu_torch import data as tdata
from celldetection_tpu_torch import models as tmodels
from celldetection_tpu_torch.runtime.trainer import CPNTrainer as TTrainer
from celldetection_tpu_torch.util import _msgpack as tmsgpack
from celldetection_tpu_torch.util import init as tinit
from celldetection_tpu_torch.util import serialization as tser
from celldetection_tpu_torch.util import torch_import as timport
from celldetection_tpu_torch.util.weights import (init_jax_variables,
                                                  jax_variables_from_state_dict,
                                                  state_dict_from_jax)
from test_torch_port_cpn import one_torch_thread  # noqa: F401  (pytestmark)

pytestmark = pytest.mark.usefixtures('one_torch_thread')

FIXTURE = os.path.join(os.path.dirname(__file__), 'fixtures', 'cpnu12_trained.cdt')
BASE, SIZE, SAMPLES = 8, 64, 16
NARROW = dict(backbone_kwargs=dict(base_channels=BASE))
NARROW_RESNET = dict(base_channel=BASE)


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in dict(tree).items()}


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def _dataset(n, seed=0, size=SIZE, num=5):
    out = []
    for i in range(n):
        img, labels = jdata.random_geometric_objects(size, size, num=num, radius=(5, 12),
                                                     seed=seed + i)
        out.append((img.astype(np.float32)[..., None], labels))
    return out


# --- repair a: initialization ---------------------------------------------------------------

_NEW_MODELS = {
    'CpnU22': lambda **kw: tmodels.CpnU22(in_channels=1, device='cpu', **NARROW, **kw),
    'CpnResNet18FPN': lambda **kw: tmodels.CpnResNet18FPN(
        in_channels=3, device='cpu', backbone_kwargs=dict(NARROW_RESNET), **kw),
}


@pytest.mark.parametrize('name', sorted(_NEW_MODELS))
def test_torch_init_bounds_and_zero_biases(name):
    torch.manual_seed(0)
    model = _NEW_MODELS[name]()
    schemes = tinit.module_schemes(model)
    modules = dict(model.named_modules())
    decoder = [n for n, (_, s) in schemes.items() if s == 'kaiming_uniform_a1']
    assert decoder and len(decoder) < len(schemes)
    for n, (path, scheme) in schemes.items():
        m = modules[n]
        fan_in = m.weight[0].numel()
        w = m.weight.detach().abs()
        if scheme == 'kaiming_uniform_a1':
            assert path[1] in ('unet', 'fpn'), n
            bound = np.sqrt(3. / fan_in)
            assert m.bias is None or not m.bias.any(), f'{n}: bias not zero'
        else:
            assert scheme == 'torch_conv' and path[1] not in ('unet', 'fpn'), n
            bound = 1. / np.sqrt(fan_in)
            assert m.bias is None or m.bias.any(), f'{n}: bias left at zero'
        assert float(w.max()) <= bound, n
        if w.numel() >= 2000:   # the draws fill the interval
            assert float(w.max()) > 0.95 * bound, n
            assert abs(float(w.mean()) / bound - 0.5) < 0.05, n


def test_torch_init_seed_and_option():
    a, b = _NEW_MODELS['CpnU22'](), _NEW_MODELS['CpnU22']()
    c = _NEW_MODELS['CpnU22'](seed=1)
    off = _NEW_MODELS['CpnU22'](torch_init=False)
    key = 'core.backbone.unet.layer_blocks.1.0.weight'
    assert torch.equal(a.state_dict()[key], b.state_dict()[key])
    assert not torch.equal(a.state_dict()[key], c.state_dict()[key])
    fan_in = off.state_dict()[key][0].numel()
    assert float(off.state_dict()[key].abs().max()) <= 1. / np.sqrt(fan_in)
    assert off.state_dict()['core.backbone.unet.layer_blocks.1.0.bias'].any()


def _jax_kernel_paths(tree, path=()):
    """Flax paths of every dict holding a kernel, as ``torch_init_variables`` walks them."""
    out = []
    if 'kernel' in tree:
        out.append(path)
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _jax_kernel_paths(v, path + (k,))
    return out


@pytest.mark.parametrize('name,in_channels', [('CpnU22', 1), ('CpnResNet18FPN', 3)])
def test_torch_init_schemes_match_jax(name, in_channels):
    kw = NARROW if name == 'CpnU22' else dict(backbone_kwargs=NARROW_RESNET)
    jm = jmodels.get_cpn(name)(in_channels, backbone_kwargs=dict(kw['backbone_kwargs']))
    shapes = jax.eval_shape(lambda: jm.core.init({'params': jax.random.PRNGKey(0)},
                                                 jnp.zeros((1, SIZE, SIZE, in_channels)), False))
    family = jinit.detect_encoder_family(jm.core.backbone)
    want = {p: jinit._resolve_scheme(p, family) for p in _jax_kernel_paths(shapes['params'])}
    pm = tmodels.get_cpn(name)(in_channels, device='cpu',
                               backbone_kwargs=dict(kw['backbone_kwargs']))
    got = {path: scheme for path, scheme in tinit.module_schemes(pm).values()}
    assert tinit.detect_encoder_family(pm.core.backbone) == family
    assert got == want


# --- repair b: forward with targets ---------------------------------------------------------

def test_forward_with_targets_matches_jax():
    k = SIZE * SIZE
    kw = dict(in_channels=1, max_detections=k, samples=SAMPLES, **NARROW)
    pm = tmodels.CpnU12(device='cpu', **kw)
    variables = init_jax_variables(pm, 4)
    pm.load_state_dict(state_dict_from_jax(variables), strict=True)
    jm = jmodels.CpnU12(**kw)
    jm.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    items = _dataset(1, seed=30)
    targets = [tdata.cpn_targets_single(lab.copy(), SAMPLES, 5, rng=np.random.RandomState(i))
               for i, (_, lab) in enumerate(items)]
    t = tdata.collate_cpn_targets(targets, max_instances=16)
    t.pop('num_instances')
    x = np.stack([im for im, _ in items])
    want = jm(x, targets=t, score_thresh=0.5)
    got = pm(x, targets=t, score_thresh=0.5)
    assert set(got['losses']) == set(want['losses'])
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-5)
    for key, v in want['losses'].items():
        np.testing.assert_allclose(got['losses'][key], v, rtol=1e-5, err_msg=key)
    assert [len(c) for c in got['contours']] == [len(c) for c in want['contours']]
    # detach keeps the loss of a padded forward as well
    out = pm.forward_padded(torch.from_numpy(x),
                            targets={k: torch.from_numpy(v) for k, v in t.items()})
    kept = pm.detach(out)
    assert float(kept['loss']) == float(out['loss']) and set(kept['losses']) == set(out['losses'])


# --- repair c: cv2's positional arguments ---------------------------------------------------

def _overlapping_labels():
    lab = np.zeros((48, 48, 2), np.int32)
    yy, xx = np.mgrid[:48, :48]
    lab[..., 0][(yy - 20) ** 2 + (xx - 18) ** 2 < 100] = 1
    lab[..., 1][(yy - 26) ** 2 + (xx - 28) ** 2 < 120] = 2
    lab[..., 0][(yy - 38) ** 2 + (xx - 8) ** 2 < 25] = 3
    return lab


def test_labels2distances_takes_jax_positions():
    from celldetection_tpu.data import cpn as jcpn
    from celldetection_tpu_torch.data import cpn as tcpn
    lab = _overlapping_labels()
    # JAX's labels2distances(labels, cv2.DIST_L2, overlap_zero, per_instance)
    for args in ((2,), (2, False), (2, False, False), (2, True, False)):
        (dj, lj), (dt, lt) = jcpn.labels2distances(lab, *args), tcpn.labels2distances(lab, *args)
        np.testing.assert_array_equal(dt, dj, err_msg=str(args))
        np.testing.assert_array_equal(lt, lj, err_msg=str(args))
    with pytest.raises(NotImplementedError, match='distance_type=2'):
        tcpn.labels2distances(lab, 1)


def test_labels2contours_takes_jax_positions():
    from celldetection_tpu.data import cpn as jcpn
    from celldetection_tpu_torch.data import cpn as tcpn
    lab = _overlapping_labels()
    want = jcpn.labels2contours(lab.copy(), 0, 1)
    got = tcpn.labels2contours(lab.copy(), 0, 1)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    with pytest.raises(NotImplementedError, match='mode=0'):
        tcpn.labels2contours(lab, 3)
    with pytest.raises(NotImplementedError, match='method=1'):
        tcpn.labels2contours(lab, 0, 2)


# --- msgpack --------------------------------------------------------------------------------

_leaves = (st.none() | st.booleans() | st.integers(-2 ** 63, 2 ** 64 - 1)
           | st.floats(allow_nan=False) | st.text(max_size=300) | st.binary(max_size=300))
_trees = st.recursive(
    _leaves, lambda c: st.lists(c, max_size=20) | st.dictionaries(
        st.text(max_size=8) | st.integers(-100, 100), c, max_size=20), max_leaves=60)


@settings(max_examples=150, deadline=None, database=None)
@given(_trees)
def test_msgpack_bytes_equal_msgpack(tree):
    want = msgpack.packb(tree, use_bin_type=True)
    assert tmsgpack.packb(tree) == want
    assert tmsgpack.unpackb(want) == msgpack.unpackb(want, strict_map_key=False)


def test_msgpack_long_containers_equal_msgpack():
    for n in (15, 16, 255, 256, 65535, 65536):
        for tree in (list(range(n)), {str(i): i for i in range(n)}, 'x' * n, b'y' * n):
            want = msgpack.packb(tree, use_bin_type=True)
            assert tmsgpack.packb(tree) == want, (type(tree), n)
            assert tmsgpack.unpackb(want) == tree


def _cpnu22_variables():
    pm = tmodels.CpnU22(in_channels=1, device='cpu', **NARROW)
    return init_jax_variables(pm, 2)


def test_msgpack_reads_and_writes_flax_arrays():
    variables = _cpnu22_variables()
    variables['extra'] = {'scalar': np.float32(1.5), 'int': np.array(7, np.int64),
                          'empty': np.zeros((0, 3), np.float32), 'flag': np.array([True, False]),
                          'half': np.arange(6, dtype=np.float16).reshape(2, 3)}
    flax_bytes = serialization.to_bytes(variables)
    got = tmsgpack.msgpack_restore(flax_bytes)
    want = serialization.msgpack_restore(flax_bytes)
    jax.tree_util.tree_map(lambda a, b: (np.testing.assert_array_equal(a, b),
                                         np.testing.assert_equal(a.dtype, b.dtype)), got, want)
    port_bytes = tmsgpack.msgpack_serialize(variables)
    assert port_bytes == serialization.msgpack_serialize(variables)
    back = serialization.msgpack_restore(port_bytes)
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a, b), back, variables)
    assert type(back['extra']['scalar']) is np.float32


def test_msgpack_chunked_arrays(monkeypatch):
    tree = {'big': np.arange(1000, dtype=np.float32).reshape(10, 100),
            'small': np.ones(3, np.int32)}
    monkeypatch.setattr(serialization, 'MAX_CHUNK_SIZE', 256)
    flax_bytes = serialization.msgpack_serialize(tree)
    assert b'__msgpack_chunked_array__' in flax_bytes
    got = tmsgpack.msgpack_restore(flax_bytes)
    np.testing.assert_array_equal(got['big'], tree['big'])
    monkeypatch.setattr(tmsgpack, 'MAX_CHUNK_SIZE', 256)
    assert tmsgpack.msgpack_serialize(tree) == flax_bytes


# --- cdt files ------------------------------------------------------------------------------

def test_fixture_reads_bit_equal_without_flax():
    with open(FIXTURE, 'rb') as f:
        payload = msgpack.unpackb(f.read(), strict_map_key=False)
    want = state_dict_from_jax(_numpy_tree(serialization.msgpack_restore(payload['params_bytes'])))
    model = tser.load_model(FIXTURE, device='cpu')
    _assert_state_equal(model.state_dict(), want)
    kwargs = json.loads(payload['cdt.models'])['kwargs']
    for attr in ('score_thresh', 'nms_thresh', 'samples', 'order', 'max_detections',
                 'refinement_iterations'):
        assert getattr(model, attr) == kwargs[attr], attr
    assert tser.load_model_meta(FIXTURE) == jser.load_model_meta(FIXTURE)


# the run-time settings a file records (order and the rest of the architecture
# cannot change after construction)
_THRESH = dict(score_thresh=0.61, nms_thresh=0.35, samples=12, max_detections=96,
               refinement_iterations=3)


def test_jax_save_model_loads_in_port(tmp_path):
    jm = jmodels.CpnU12(in_channels=2, max_detections=64, samples=8, **NARROW)
    # seeded weights without JAX's eager init (the file holds whatever variables are set)
    jm.variables = init_jax_variables(
        tmodels.CpnU12(in_channels=2, max_detections=64, samples=8, device='cpu', **NARROW), 3)
    for k, v in _THRESH.items():
        setattr(jm, k, v)
    fn = str(tmp_path / 'jax.cdt')
    jutil.save_model(fn, jm, meta={'who': 'jax'})
    pm = tser.load_model(fn, device='cpu')
    _assert_state_equal(pm.state_dict(), state_dict_from_jax(_numpy_tree(jm.variables)))
    for k, v in _THRESH.items():
        assert getattr(pm, k) == v, k
    assert tser.load_model_meta(fn)['who'] == 'jax'


@pytest.mark.parametrize('name,fused', [('CpnU12', False), ('CpnResNet18UNet', True)])
def test_port_save_model_loads_in_jax(tmp_path, name, fused):
    kw = NARROW if name == 'CpnU12' else \
        dict(backbone_kwargs=dict(fused_initial=fused, **NARROW_RESNET))
    in_channels = 1 if name == 'CpnU12' else 3
    pm = tmodels.get_cpn(name)(in_channels=in_channels, device='cpu', max_detections=64, **kw)
    pm.load_state_dict(state_dict_from_jax(init_jax_variables(pm, 5), fused), strict=True)
    for k, v in _THRESH.items():
        setattr(pm, k, v)
    fn = str(tmp_path / 'port.cdt')
    tser.save_model(fn, pm, meta={'who': 'port'})
    # no re-draw, and the template of the forward test above, whose operations
    # JAX has compiled already: the JAX package's init runs op by op
    jm = jutil.load_model(fn, torch_init=False, input_shape=(1, SIZE, SIZE, in_channels))
    _assert_state_equal(state_dict_from_jax(_numpy_tree(jm.variables), fused), pm.state_dict())
    for k, v in _THRESH.items():
        assert getattr(jm, k) == v, k
    assert jser.load_model_meta(fn)['who'] == 'port'
    again = tser.load_model(fn, device='cpu')
    _assert_state_equal(again.state_dict(), pm.state_dict())
    if name != 'CpnU12':
        assert again.core.backbone.body.fused_initial == fused


def test_dict2model_refuses_unported_options():
    # the JAX CPN's parameter dtype is not ported; the head options are
    d = {'cdt.models': {'model': 'CpnU12', 'kwargs': dict(in_channels=1, dtype='float64',
                                                          uncertainty_head=True, **NARROW)}}
    with pytest.raises(NotImplementedError, match='dtype'):
        tser.dict2model(d, device='cpu')
    d['cdt.models']['kwargs'].update(dtype=None, certainty_thresh=0.4)
    model = tser.dict2model(d, device='cpu')
    assert model.samples == 32 and model.certainty_thresh == 0.4
    assert model.core.uncertainty_head is not None


# --- reference .pt and Lightning .ckpt files ------------------------------------------------

def _reference_files(tmp_path, fused):
    """A narrow CpnResNet18UNet from the JAX package and its reference-format
    files: a cd-format ``.pt`` (keys without ``core.``) and a Lightning
    ``.ckpt`` (keys under ``model.``), from ``export_torch_state_dict``. A
    fused stem has a decoder of its own, so the stored kwargs name it."""
    backbone_kwargs = dict(NARROW_RESNET, **({'fused_initial': True} if fused else {}))
    kwargs = dict(in_channels=3, max_detections=32, samples=8, score_thresh=0.7,
                  backbone_kwargs=backbone_kwargs)
    jm = jmodels.CpnResNet18UNet(**{**kwargs, 'backbone_kwargs': dict(backbone_kwargs)})
    jm.variables = init_jax_variables(tmodels.CpnResNet18UNet(
        device='cpu', **{**kwargs, 'backbone_kwargs': dict(backbone_kwargs)}), 1)
    sd = jutil.export_torch_state_dict(jm.variables, fused_initial=fused, encoder='resnet')
    sd = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    pt, ckpt = str(tmp_path / f'ref_{fused}.pt'), str(tmp_path / f'ref_{fused}.ckpt')
    torch.save({'cd.models': {'model': 'CpnResNet18UNet', 'kwargs': kwargs},
                'state_dict': {k[len('core.'):]: v for k, v in sd.items()},
                'cd.__version__': '0.4.9'}, pt)
    torch.save({'state_dict': {f'model.{k}': v for k, v in sd.items()},
                'hyper_parameters': {'model': 'CpnResNet18UNet', 'kwargs': kwargs}}, ckpt)
    return jm, pt, ckpt


@pytest.mark.parametrize('fused', [False, True])
def test_reference_pt_and_ckpt_load_equal_to_jax(tmp_path, fused):
    jm, pt, ckpt = _reference_files(tmp_path, fused)
    want = state_dict_from_jax(_numpy_tree(jm.variables), fused)
    for fn in (pt, ckpt):
        jl = j_load_torch(fn, input_shape=(1, 32, 32, 3), torch_init=False)
        _assert_state_equal(state_dict_from_jax(_numpy_tree(jl.variables), fused), want)
        pm = tser.load_model(fn, device='cpu')
        assert pm.core.backbone.body.fused_initial == fused
        _assert_state_equal(pm.state_dict(), want)
        assert pm.score_thresh == jl.score_thresh == 0.7 and pm.samples == 8


def test_reference_classes_become_placeholders(tmp_path, monkeypatch):
    mod = tmp_path / 'refmodels_probe.py'
    mod.write_text('class CpnU12:\n    pass\n')
    monkeypatch.syspath_prepend(str(tmp_path))
    import refmodels_probe
    pm = tmodels.CpnU12(in_channels=1, device='cpu', max_detections=16, **NARROW)
    fn = str(tmp_path / 'with_class.pt')
    torch.save({'cd.models': {'model': refmodels_probe.CpnU12,
                              'kwargs': dict(in_channels=1, max_detections=16, **NARROW)},
                'state_dict': {k[len('core.'):]: v for k, v in pm.state_dict().items()}}, fn)
    del sys.modules['refmodels_probe']
    monkeypatch.delattr(refmodels_probe, 'CpnU12')   # an import could not find it either
    got = timport.load_torch_cd_model(fn, device='cpu')
    assert 'refmodels_probe' not in sys.modules
    _assert_state_equal(got.state_dict(), pm.state_dict())
    data = torch.load(fn, weights_only=False, pickle_module=timport.restricted_pickle)
    cls = data['cd.models']['model']
    assert cls.__name__ == 'CpnU12' and issubclass(cls, timport._Placeholder)


# --- fetch_model ----------------------------------------------------------------------------

def _saved_fixture_copy(tmp_path, name):
    path = tmp_path / name
    path.write_bytes(open(FIXTURE, 'rb').read())
    return path


def test_fetch_model_offline(tmp_path, monkeypatch):
    import urllib.request
    digest = tser.hash_file(FIXTURE)[:16]
    cache = tmp_path / 'cache'
    cache.mkdir()

    def no_network(url, filename):
        raise AssertionError(f'tried to download {url}')

    monkeypatch.setattr(urllib.request, 'urlretrieve', no_network)
    # a cache hit: the hashed name in the cache dir loads without a download
    _saved_fixture_copy(cache, f'cpnu12-{digest}.cdt')
    monkeypatch.setitem(tser.hosted_models, 'cpnu12', f'https://host.invalid/cpnu12-{digest}.cdt')
    m = tser.fetch_model('cpnu12', cache_dir=str(cache), device='cpu')
    assert m.samples == 24
    # a hash mismatch: the file is removed and the call raises
    bad = _saved_fixture_copy(cache, 'bad-0123456789abcdef.cdt')
    with pytest.raises(RuntimeError, match='Hash mismatch'):
        tser.fetch_model('https://host.invalid/bad-0123456789abcdef.cdt', cache_dir=str(cache))
    assert not bad.exists()
    with pytest.raises(ValueError, match='Unknown hosted model'):
        tser.fetch_model('no-such-model', cache_dir=str(cache))
    # a download, through a local stand-in for urlretrieve
    calls = []

    def local_copy(url, filename):
        calls.append((url, os.path.basename(filename)))
        with open(filename, 'wb') as f:
            f.write(open(FIXTURE, 'rb').read())

    monkeypatch.setattr(urllib.request, 'urlretrieve', local_copy)
    url = f'https://host.invalid/models/trained-{digest}.cdt'
    m = tser.fetch_model(f'cd://{url}', cache_dir=str(cache), device='cpu')
    assert calls == [(url, f'trained-{digest}.cdt.part')] and m.samples == 24
    assert sorted(os.listdir(cache)) == sorted([f'cpnu12-{digest}.cdt', f'trained-{digest}.cdt'])
    fn = tser.save_fetchable_model(str(tmp_path / 'mine.cdt'), m)
    assert os.path.basename(fn) == f'mine-{tser.hash_file(fn)[:16]}.cdt'
    assert tser.fetch_model(fn, device='cpu').samples == 24


# --- trainer checkpoints --------------------------------------------------------------------

def _trainer(seed_weights=3):
    pm = tmodels.CpnU22(in_channels=1, device='cpu', max_detections=256, samples=SAMPLES,
                        **NARROW)
    pm.load_state_dict(state_dict_from_jax(init_jax_variables(pm, seed_weights)), strict=True)
    return TTrainer(pm, optimizer={'Adam': {'lr': 1e-3}}, scheduler=lambda s: 0.5 ** s,
                    log_fn=lambda *a: None, seed=4)


def test_trainer_checkpoint_resumes_bit_equal(tmp_path):
    data = _dataset(4, seed=60)
    fit = dict(epochs=1, batch_size=2, max_instances=16)
    whole = _trainer()
    whole.fit(data, **fit)
    whole.fit(data, **fit)
    first = _trainer()
    first.fit(data, **fit)
    first.best_hparams = {'score_thresh': 0.88}
    path = str(tmp_path / 'ckpt' / 'run.ckpt')
    first.save_checkpoint(path)
    resumed = _trainer(seed_weights=9)
    resumed.load_checkpoint(path)
    assert resumed.state.step == 2 and resumed.best_hparams == {'score_thresh': 0.88}
    resumed.fit(data, **fit)
    assert [h['loss'] for h in whole.history] == \
        [first.history[0]['loss'], resumed.history[0]['loss']]
    _assert_state_equal(resumed.model.state_dict(), whole.model.state_dict())
    # flax reads the weights into the JAX model's tree
    with open(path, 'rb') as f:
        payload = msgpack.unpackb(f.read(), strict_map_key=False)
    jm = jmodels.CpnU22(1, max_detections=256, samples=SAMPLES, **NARROW)
    template = jm.core.init({'params': jax.random.PRNGKey(0)}, jnp.zeros((1, SIZE, SIZE, 1)),
                            False)
    restored = serialization.from_bytes(template, payload['variables'])
    _assert_state_equal(state_dict_from_jax(_numpy_tree(restored)), first.model.state_dict())
    with pytest.raises(NotImplementedError, match='Orbax'):
        first.save_checkpoint(path, backend='orbax')


def test_fit_writes_last_checkpoint(tmp_path):
    tr = _trainer()
    tr.checkpoint_dir = str(tmp_path / 'run')
    tr.fit(_dataset(2, seed=70), epochs=2, batch_size=2, max_instances=16)
    again = _trainer(seed_weights=11)
    again.load_checkpoint(os.path.join(tr.checkpoint_dir, 'last.ckpt'))
    assert again.state.step == 2 and again._np_seed_counter == 1
    _assert_state_equal(again.model.state_dict(), tr.model.state_dict())
    variables = jax_variables_from_state_dict(tr.model.state_dict())
    assert zlib.crc32(tmsgpack.msgpack_serialize(variables)) == zlib.crc32(
        serialization.msgpack_serialize(variables))
