"""Port parity: the runtime utilities (``util/{timer,system,surgery,misc,shm_cache,rois,pt_pickle}``).

The same numpy-seeded inputs go through the JAX package and
``celldetection_tpu_torch`` on the CPU:

* timers and system: ``print_timing``'s lines, ``Timer``, a Chrome trace from
  ``profiler_trace``, ``Bytes``/``Percent``/``num_bytes``, the random states
  (Python, numpy, torch and a ``torch.Generator``) saved and restored,
  ``OomCatcher`` retrying with the JAX package's sizes on a raised
  ``torch.cuda.OutOfMemoryError``, ``get_total_memory`` on the CPU;
* surgery on a tiny CpnU22's parameters, the port's named parameters against
  the JAX package's tree through ``state_dict_from_jax``'s mapping: the
  default pattern selects exactly the JAX package's ``kernel$`` leaves (the
  weights of two or more axes, not the norms' ``weight``), user patterns the
  same leaves; ``spectral_normalize`` within 1e-5 relative, ``weight_normalize``
  and ``ema_update`` within 1e-6; ``frozen_optimizer``: three Adam steps of
  both packages on the same weights and gradients, the frozen parameters
  bit-equal, the others within 1e-5 relative;
* ``misc`` (each function against the JAX package's), ``ShmCache``, the
  ImageJ ROI bytes, ``load_pt`` against the JAX package's reader, and its
  refusal of a pickle that calls ``os.system``.
"""
import os
import pickle
import random
import time
import zipfile
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from celldetection_tpu.util import misc as jmisc
from celldetection_tpu.util import pt_pickle as jpt
from celldetection_tpu.util import rois as jrois
from celldetection_tpu.util import shm_cache as jshm
from celldetection_tpu.util import surgery as jsurgery
from celldetection_tpu.util import system as jsystem
from celldetection_tpu.util import timer as jtimer
from celldetection_tpu_torch import models as tmodels
from celldetection_tpu_torch.util import misc as tmisc
from celldetection_tpu_torch.util import pt_pickle as tpt
from celldetection_tpu_torch.util import rois as trois
from celldetection_tpu_torch.util import shm_cache as tshm
from celldetection_tpu_torch.util import surgery as tsurgery
from celldetection_tpu_torch.util import system as tsystem
from celldetection_tpu_torch.util import timer as ttimer
from celldetection_tpu_torch.util.weights import (_flatten, _port_key, init_jax_variables,
                                                  state_dict_from_jax)
from test_torch_port_cpn import one_torch_thread  # noqa: F401  (pytestmark)

pytestmark = pytest.mark.usefixtures('one_torch_thread')


# -- timer and system ----------------------------------------------------------

def test_print_timing_and_timers_match_jax(capsys, tmp_path):
    for seconds in (12.3456, 0.5, 0.0012345, 3e-7, 0.):
        jtimer.print_timing('forward', seconds)
        want = capsys.readouterr().out
        ttimer.print_timing('forward', seconds)
        assert capsys.readouterr().out == want
    ttimer.start_timer('a')
    time.sleep(0.01)
    assert ttimer.stop_timer('a', verbose=False) >= 0.01
    with ttimer.timed('b', verbose=True):
        pass
    assert capsys.readouterr().out.startswith('b: ')
    with ttimer.Timer('t', sync=True) as t:
        time.sleep(0.01)
    assert t.seconds >= 0.01
    with ttimer.profiler_trace(str(tmp_path / 'prof')):
        torch.ones(8).sum()
    assert os.path.getsize(tmp_path / 'prof' / 'trace.json') > 0


def test_sizes_and_formats_match_jax():
    for x in (np.zeros((3, 5), np.float32), np.zeros(7, np.int64), np.zeros((), np.uint8)):
        assert tsystem.num_bytes(x) == jsystem.num_bytes(x)
        assert tsystem.num_bytes(torch.from_numpy(x)) == jsystem.num_bytes(x)
    for v in (0, 1000, 5 * 2 ** 20, 3 * 2 ** 41, 2 ** 60):
        assert str(tsystem.Bytes(v)) == str(jsystem.Bytes(v))
    assert str(tsystem.Percent(0.4567)) == str(jsystem.Percent(0.4567)) == '45.7%'
    assert tsystem.TpuStats is tsystem.GpuStats
    assert tsystem.GpuStats(devices=[]).dict() == {} and str(tsystem.GpuStats([])) == ''


def test_random_states_round_trip(tmp_path):
    fn = str(tmp_path / 'states.pkl')
    g = torch.Generator().manual_seed(3)
    random.seed(1)
    np.random.seed(1)
    torch.manual_seed(1)
    tsystem.save_random_states(fn, generator=g)
    first = (random.random(), np.random.rand(3), torch.rand(3), torch.rand(3, generator=g))
    g2 = tsystem.load_random_states(fn)
    again = (random.random(), np.random.rand(3), torch.rand(3), torch.rand(3, generator=g2))
    assert first[0] == again[0]
    np.testing.assert_array_equal(first[1], again[1])
    for a, b in zip(first[2:], again[2:]):
        assert torch.equal(a, b)
    states = tsystem.get_random_states()
    assert set(states) >= {'random', 'numpy', 'torch'}
    assert tsystem.load_random_states(fn) is not None
    with open(fn, 'rb') as f:
        assert 'jax' not in pickle.load(f)


def test_random_seed_seeds_every_generator():
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    try:
        g = tsystem.random_seed(5)
        assert random.random() == random.Random(5).random()
        assert np.random.rand() == np.random.RandomState(5).rand()
        assert torch.equal(torch.rand(4), torch.rand(4, generator=torch.Generator().manual_seed(5)))
        assert torch.equal(torch.rand(2, generator=g),
                           torch.rand(2, generator=torch.Generator().manual_seed(5)))
        assert torch.backends.cudnn.deterministic
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


def _retry(catcher, error):
    sizes = []
    for size in catcher:
        with catcher:
            sizes.append(size)
            if size > 10:
                raise error
    return sizes, catcher.ok


def test_oom_catcher_retries_as_jax():
    want = _retry(jsystem.OomCatcher(attempts=4, initial=64, verbose=False),
                  RuntimeError('RESOURCE_EXHAUSTED: out of HBM'))
    got = _retry(tsystem.OomCatcher(attempts=4, initial=64, verbose=False),
                 torch.cuda.OutOfMemoryError('CUDA error: out of memory'))
    assert got == want == ([64, 32, 16, 8], True)
    with pytest.raises(torch.cuda.OutOfMemoryError):        # attempts exhausted
        _retry(tsystem.OomCatcher(attempts=2, initial=64, verbose=False),
               torch.cuda.OutOfMemoryError('out of memory'))
    with pytest.raises(ValueError):                          # not an OOM
        _retry(tsystem.OomCatcher(attempts=4, initial=64, verbose=False), ValueError('bad'))


def test_total_memory_on_the_cpu():
    total = tsystem.get_total_memory('cpu')
    assert total == os.sysconf('SC_PAGE_SIZE') * os.sysconf('SC_PHYS_PAGES') > 0
    assert 'B' in str(total)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            tsystem.get_total_memory()


# -- surgery -------------------------------------------------------------------

@pytest.fixture(scope='module')
def cpn():
    """A tiny CpnU22 on the CPU, its JAX variables, and the map from each JAX
    parameter path ('/'-joined) to the port's name."""
    pm = tmodels.CpnU22(in_channels=1, backbone_kwargs=dict(base_channels=8), device='cpu',
                        max_detections=32, samples=8)
    variables = init_jax_variables(pm, 7)
    pm.load_state_dict(state_dict_from_jax(variables), strict=True)
    names = {'/'.join(path): _port_key('params', path) for path, _ in
             _flatten(variables['params'])}
    assert set(names.values()) == {n for n, _ in pm.named_parameters()}
    return pm, variables, names


def _as_port(variables, params):
    """A JAX params tree as the port's state dict (the batch statistics kept)."""
    return state_dict_from_jax({'params': params, 'batch_stats': variables['batch_stats']})


@pytest.mark.parametrize('jax_pattern, port_pattern', [
    (r'kernel$', None), (r'score_head', r'score_head'), (r'backbone', r'backbone'),
    (r'bias$', r'bias$'), (r'.*', r'.*')])
def test_patterns_select_the_jax_leaves(cpn, jax_pattern, port_pattern):
    pm, variables, names = cpn
    want = {names[p] for p in jsurgery.match_paths(variables['params'], jax_pattern)}
    got = tsurgery.match_paths(pm, port_pattern)
    assert got == want and got
    assert got == tsurgery.match_paths(dict(pm.named_parameters()), port_pattern)
    assert [n for n, _ in tsurgery.iter_params(pm, port_pattern)] == \
        [n for n, _ in pm.named_parameters() if n in got]
    if jax_pattern == r'kernel$':
        assert all(pm.get_parameter(n).dim() >= 2 for n in got)
        assert any(n.endswith('weight') and pm.get_parameter(n).dim() == 1
                   for n, _ in pm.named_parameters())   # the norms' scales stay out


def test_map_and_replace_params_match_jax(cpn):
    pm, variables, names = cpn
    params = variables['params']
    want = _as_port(variables, jsurgery.map_params(params, lambda s, v: v * 2., 'score_head'))
    sd = {n: p.detach().clone() for n, p in pm.named_parameters()}
    got = tsurgery.map_params(sd, lambda n, v: v * 2., 'score_head')
    for n in sd:
        assert torch.equal(got[n], want[n]), n
    key = 'score_head/conv1/bias'
    new = np.arange(params['score_head']['conv1']['bias'].size, dtype=np.float32)
    want = _as_port(variables, jsurgery.replace_params(params, {key: new}))
    got = tsurgery.replace_params(sd, {names[key]: new})
    assert torch.equal(got[names[key]], want[names[key]]) and got is not sd
    with pytest.raises(KeyError):
        tsurgery.replace_params(sd, {'core.nope': new})
    with pytest.raises(ValueError):
        tsurgery.replace_params(sd, {names[key]: new[:-1]})
    mask = tsurgery.freeze_mask(pm, 'backbone')
    jmask = dict(_flatten(jsurgery.freeze_mask(params, 'backbone')))
    assert mask == {names['/'.join(p)]: bool(v) for p, v in jmask.items()}
    assert tsurgery.count_params(pm) == jsurgery.count_params(params)


def test_map_params_on_a_module_is_in_place(cpn):
    pm, _, _ = cpn
    m = tmodels.CpnU22(in_channels=1, backbone_kwargs=dict(base_channels=8), device='cpu',
                       max_detections=32, samples=8)
    m.load_state_dict(pm.state_dict())
    name = 'core.score_head.block.4.bias'
    before = m.get_parameter(name).detach().clone()
    assert tsurgery.map_params(m, lambda n, v: v + 1., r'score_head\.block\.4\.bias$') is m
    assert torch.equal(m.get_parameter(name).detach(), before + 1.)
    tsurgery.replace_params(m, {name: before})
    assert torch.equal(m.get_parameter(name).detach(), before)


@pytest.mark.parametrize('norm', ['spectral', 'weight'])
def test_normalizations_match_jax(cpn, norm):
    pm, variables, names = cpn
    jfn = {'spectral': jsurgery.spectral_norm_, 'weight': jsurgery.weight_norm_}[norm]
    tfn = {'spectral': tsurgery.spectral_norm_, 'weight': tsurgery.weight_norm_}[norm]
    rtol = 1e-5 if norm == 'spectral' else 1e-6
    want = _as_port(variables, jfn(variables['params']))
    got = tfn({n: p.detach() for n, p in pm.named_parameters()})
    selected = tsurgery.match_paths(pm, None)
    for n, v in got.items():
        if n in selected:
            np.testing.assert_allclose(v.numpy(), want[n].numpy(), rtol=rtol,
                                       atol=rtol * float(want[n].abs().max()), err_msg=n)
        else:
            assert torch.equal(v, want[n]), n
    # a user pattern and the module form
    want = _as_port(variables, jfn(variables['params'], pattern='fourier_head/conv0/kernel$'))
    m = tmodels.CpnU22(in_channels=1, backbone_kwargs=dict(base_channels=8), device='cpu',
                       max_detections=32, samples=8)
    m.load_state_dict(pm.state_dict())
    tfn(m, pattern=r'fourier_head\.block\.0\.weight$')
    n = names['fourier_head/conv0/kernel']
    np.testing.assert_allclose(m.get_parameter(n).detach().numpy(), want[n].numpy(), rtol=rtol,
                               atol=rtol * float(want[n].abs().max()))


def test_ema_update_matches_jax(cpn):
    pm, variables, names = cpn
    params = variables['params']
    other = jax.tree_util.tree_map(lambda v: v * np.float32(0.5) + np.float32(0.1), params)
    want = _as_port(variables, jsurgery.exponential_moving_average_(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, other), decay=0.9))
    sd_other = _as_port(variables, other)
    ema = {n: p.detach().clone() for n, p in pm.named_parameters()}
    got = tsurgery.ema_update(ema, {n: sd_other[n] for n in ema}, decay=0.9)
    for n, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[n].numpy(), rtol=1e-6, atol=1e-7, err_msg=n)
    m = tmodels.CpnU22(in_channels=1, backbone_kwargs=dict(base_channels=8), device='cpu',
                       max_detections=32, samples=8)
    m.load_state_dict(pm.state_dict())
    src = tmodels.CpnU22(in_channels=1, backbone_kwargs=dict(base_channels=8), device='cpu',
                         max_detections=32, samples=8)
    src.load_state_dict(sd_other)
    assert tsurgery.ema_update(m, src, decay=0.9) is m
    for n, p in m.named_parameters():
        assert torch.equal(p.detach(), got[n]), n


def test_frozen_optimizer_matches_optax(cpn):
    """Three Adam steps with the encoder frozen: optax's ``masked`` with
    ``set_to_zero`` against an Adam over the unfrozen parameters alone."""
    pm, variables, names = cpn
    params = jax.tree_util.tree_map(jnp.asarray, variables['params'])
    rng = np.random.RandomState(0)
    grads = [jax.tree_util.tree_map(lambda v: rng.randn(*v.shape).astype(np.float32), params)
             for _ in range(3)]
    tx = jsurgery.frozen_optimizer(optax.adam(1e-3), params, 'backbone')
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
    want = _as_port(variables, params)

    m = tmodels.CpnU22(in_channels=1, backbone_kwargs=dict(base_channels=8), device='cpu',
                       max_detections=32, samples=8)
    m.load_state_dict(pm.state_dict())
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    opt = tsurgery.frozen_optimizer({'Adam': {'lr': 1e-3}}, m, 'backbone')
    frozen = tsurgery.match_paths(m, 'backbone')
    assert {n for n, p in m.named_parameters() if not p.requires_grad} == frozen
    assert sum(len(g['params']) for g in opt.param_groups) == \
        sum(1 for n, _ in m.named_parameters() if n not in frozen)
    for g in grads:
        sd_g = _as_port(variables, g)
        for n, p in m.named_parameters():
            p.grad = sd_g[n].clone() if p.requires_grad else None
        opt.step()
    for n, p in m.named_parameters():
        if n in frozen:
            assert torch.equal(p.detach(), before[n]), n
        else:
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=n)
            assert not torch.equal(p.detach(), before[n]), n
    assert frozen and all(torch.equal(want[n], before[n]) for n in frozen)


# -- misc, ShmCache, ROIs, .pt ---------------------------------------------------

def test_misc_matches_jax(tmp_path, cpn):
    pm, variables, _ = cpn
    assert tmisc.random_code_name(8, rng=random.Random(3)) == \
        jmisc.random_code_name(8, rng=random.Random(3))
    for i in range(3):
        for ext in ('png', 'h5'):
            (tmp_path / f'{i}.{ext}').write_text(str(i))
    pats = (str(tmp_path / '*.png'), str(tmp_path / '*.h5'))
    assert tmisc.grouped_glob(*pats) == jmisc.grouped_glob(*pats)
    (tmp_path / 'extra.png').write_text('x')
    with pytest.raises(ValueError):
        tmisc.grouped_glob(*pats)
    url = 'https://host/model.cdt?version=2&tag=a&tag=b'
    assert tmisc.parse_url_params(url) == jmisc.parse_url_params(url)
    d = {'b': 1, 'a': [1, 2], 'f': print}
    assert tmisc.dict_to_json_string(d) == jmisc.dict_to_json_string(d)
    assert tmisc.dict_hash({'b': 1, 'a': 2}) == jmisc.dict_hash({'a': 2, 'b': 1})
    dd = tmisc.Dict(a=1)
    dd.b = 2
    assert dd == {'a': 1, 'b': 2} and dd.b == 2
    with pytest.raises(AttributeError):
        dd.c
    assert tmisc.update_dict_({'a': 1}, {'a': 2, 'b': 3}) == \
        jmisc.update_dict_({'a': 1}, {'a': 2, 'b': 3})
    assert tmisc.update_dict_({'a': 1}, {'a': 2, 'b': 3}, override=True, keys=['a']) == {'a': 2}
    assert tmisc.has_argument(tmisc.print_to_file, 'filename', 'x', mode='any')
    assert not tmisc.has_argument(tmisc.print_to_file, 'filename', 'x', mode='all')
    assert tmisc.is_picklable([1]) and not tmisc.is_picklable(lambda: 0)
    tmisc.print_to_file('a', 'b', filename=str(tmp_path / 't.txt'))
    assert tmisc.load_txt(str(tmp_path / 't.txt')) == jmisc.load_txt(str(tmp_path / 't.txt'))
    assert tmisc.compare_file_hashes(str(tmp_path / '0.png'), str(tmp_path / '0.h5'))
    assert not tmisc.compare_file_hashes(str(tmp_path / '0.png'), str(tmp_path / '1.png'))
    assert tmisc.is_package_installed('numpy') and not tmisc.is_package_installed('no_such_pkg')
    assert tmisc.is_from_installed_package(np.zeros(1)) == jmisc.is_from_installed_package(
        np.zeros(1))
    assert tmisc.is_ipython() == jmisc.is_ipython()
    assert tmisc.get_installed_packages() == jmisc.get_installed_packages()
    mod = tmisc.import_file(str(_write(tmp_path / 'mod.py', 'X = 41 + 1\n')))
    assert mod.X == 42
    random.seed(0)
    want = jmisc.say_goodbye()
    random.seed(0)
    assert tmisc.say_goodbye() == want
    out = tmisc.random_code_name_dir(str(tmp_path / 'runs'))
    assert os.path.isdir(out) and len(os.path.basename(out)) == 6
    assert tmisc.copy_script(str(tmp_path / 'copy'), str(tmp_path / 'mod.py')).endswith('mod.py')
    assert tmisc.save_requirements(str(tmp_path / 'req.txt')) == str(tmp_path / 'req.txt')
    # elements of a state dict, or of a module's parameters alone
    assert tmisc.num_params(pm) == jmisc.num_params(variables)
    assert tmisc.num_params(pm, trainable=True) == jmisc.num_params(variables, trainable=True)
    assert tmisc.num_params(pm.state_dict()) == jmisc.num_params(variables)


def _write(path, text):
    path.write_text(text)
    return path


def test_shm_cache_matches_jax(tmp_path):
    files = [str(_write(tmp_path / f'f{i}.bin', 'abc' * (i + 1))) for i in range(5)]
    want = jshm.ShmCache(root=str(tmp_path / 'jax'), num_threads=3).setup(files)
    cache = tshm.ShmCache(root=str(tmp_path / 'port'), num_threads=3)
    with cache:
        got = cache.setup(files)
        assert [os.path.relpath(p, tmp_path / 'port') for p in got] == \
            [os.path.relpath(p, tmp_path / 'jax') for p in want]
        for src, dst in zip(files, got):
            assert open(src).read() == open(dst).read()
    assert not any(os.path.exists(p) for p in got)
    with pytest.raises(FileNotFoundError):
        tshm.ShmCache(root=str(tmp_path / 'x')).setup([str(tmp_path / 'missing')])


def test_roi_bytes_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    contours = [rng.uniform(0, 300, (rng.randint(3, 40), 2)) for _ in range(12)]
    for c in contours:
        data = trois.contour2roi_bytes(c)
        assert data == jrois.contour2roi_bytes(c)
        np.testing.assert_array_equal(trois.roi_bytes2contour(data), jrois.roi_bytes2contour(data))
    for name in ('set.zip', 'one.roi'):
        cons = contours if name.endswith('.zip') else contours[:1]
        trois.save_rois(str(tmp_path / f'port_{name}'), cons)
        jrois.save_rois(str(tmp_path / f'jax_{name}'), cons)
        if name.endswith('.zip'):
            with zipfile.ZipFile(tmp_path / f'port_{name}') as a, \
                    zipfile.ZipFile(tmp_path / f'jax_{name}') as b:
                assert a.namelist() == b.namelist()
                assert all(a.read(n) == b.read(n) for n in a.namelist())
        else:
            assert (tmp_path / f'port_{name}').read_bytes() == (tmp_path / f'jax_{name}').read_bytes()
        got, want = (m.load_imagej_rois(str(tmp_path / f'port_{name}')) for m in (trois, jrois))
        np.testing.assert_array_equal(got[0], want[0])
        assert len(got[1]) == len(want[1]) == len(cons)
        for a, b in zip(got[1], want[1]):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match='Iout'):
        trois.roi_bytes2contour(b'nope' + bytes(80))


def test_load_pt_matches_jax(tmp_path):
    torch.manual_seed(0)
    sd = OrderedDict()
    sd['conv.weight'] = torch.randn(4, 3, 3, 3)
    sd['conv.bias'] = torch.arange(4, dtype=torch.float32)
    sd['bn.running_mean'] = torch.randn(7).double()
    sd['bn.num_batches_tracked'] = torch.tensor(42)
    sd['half'] = torch.randn(5).half()
    sd['bf16'] = torch.randn(5).bfloat16()
    sd['flags'] = torch.tensor([True, False, True])
    sd['noncontig'] = torch.randn(6, 8).t()
    sd['param'] = torch.nn.Parameter(torch.ones(3))
    ckpt = {'cd.models': {'model': 'CpnU22', 'kwargs': {'in_channels': 3, 'order': np.int64(6)}},
            'state_dict': sd, 'shared': [sd['conv.bias'], sd['conv.bias'][1:]]}
    fn = str(tmp_path / 'ckpt.pt')
    torch.save(ckpt, fn)
    got, want = tpt.load_pt(fn), jpt.load_pt(fn)
    assert got['cd.models'] == want['cd.models']
    assert list(got['state_dict']) == list(want['state_dict'])
    for k, v in want['state_dict'].items():
        g = got['state_dict'][k]
        assert isinstance(g, np.ndarray) and g.shape == v.shape and g.dtype == v.dtype, k
        np.testing.assert_array_equal(g.astype(np.float64), np.asarray(v).astype(np.float64))
    for a, b in zip(got['shared'], want['shared']):
        np.testing.assert_array_equal(a, b)


def test_load_pt_refuses_arbitrary_callables(tmp_path):
    """As ``tests/test_pt_pickle.py``'s case: a pickle that calls ``os.system``."""
    class Evil:
        def __reduce__(self):
            return (os.system, ('echo pwned',))

    fn = str(tmp_path / 'evil.pt')
    with zipfile.ZipFile(fn, 'w') as zf:
        zf.writestr('archive/data.pkl', pickle.dumps({'x': Evil()}))
    with pytest.raises(tpt.PTUnpickleError, match='system'):
        tpt.load_pt(fn)
    with pytest.raises(jpt.PTUnpickleError):
        jpt.load_pt(fn)
    legacy = str(tmp_path / 'legacy.pt')
    with open(legacy, 'wb') as f:
        pickle.dump({'a': 1}, f)
    with pytest.raises(tpt.PTUnpickleError, match='zip'):
        tpt.load_pt(legacy)
