"""Port parity: ``Config``, ``Schedule`` and ``conf2tweaks_`` (``util/config.py``).

* ``Config``: json and yaml files written by either package read back equal
  in the other; ``hash()`` is the JAX package's (the same md5) for nested,
  numpy-valued and private-keyed configs; ``args``/``kwargs`` bind the same;
* ``Schedule``: the same configs in the same order, with conditions;
* ``conf2tweaks_``: ``{'BatchNorm2d': {'momentum': 0.05}}`` applied after the
  trainers are built gives, after one ``fit`` step of a small CpnU22 (the
  same batch on both sides, dropout off), the JAX trainer's running
  statistics within 1e-6 of their magnitude (the gate of
  ``test_train_forward_running_statistics_match_jax``), and they differ from
  an untweaked step's; ``model.tweaks`` is the JAX package's; an unknown
  target or attribute raises in both.
"""
import flax
import jax
import numpy as np
import optax
import pytest

from celldetection_tpu.runtime.trainer import CPNTrainer as JTrainer
from celldetection_tpu.util import config as jconfig
from celldetection_tpu_torch.models.commons import Dropout2d
from celldetection_tpu_torch.runtime.trainer import CPNTrainer as TTrainer
from celldetection_tpu_torch.util import config as tconfig
from celldetection_tpu_torch.util import state_dict_from_jax
from test_torch_port_cpn import one_torch_thread  # noqa: F401  (pytestmark)
from test_torch_port_train import SAMPLES, _dataset, _models

pytestmark = pytest.mark.usefixtures('one_torch_thread')

CONFIGS = [
    dict(in_channels=1, cpn='CpnU22', order=5, samples=32, optimizer={'Adam': {'lr': 2e-3}},
         augmentation={'HorizontalFlip': {'p': .5}, 'RandomRotate90': {'p': .5}}),
    dict(classes=4, tweaks={'BatchNorm2d': {'momentum': 0.05}}, lr=np.float32(0.5),
         steps=np.int64(3), shape=np.arange(3), _private=1, name='x', flag=True, none=None),
    dict(),
]


def _both(kwargs):
    return jconfig.Config(**kwargs), tconfig.Config(**kwargs)


@pytest.mark.parametrize('i', range(len(CONFIGS)))
def test_config_hash_and_binding_match_jax(i):
    j, t = _both(CONFIGS[i])
    nested_j, nested_t = jconfig.Config(inner=j, k=1), tconfig.Config(inner=t, k=1)
    assert t.hash() == j.hash() and nested_t.hash() == nested_j.hash()
    assert str(t) == str(j) and t.to_dict() == j.to_dict()

    def fn(in_channels, order=3, classes=2, other=None):
        pass
    assert t.args(fn) == j.args(fn) and t.kwargs(fn) == j.kwargs(fn)
    assert all(getattr(t, k) is v for k, v in CONFIGS[i].items())   # attribute access


@pytest.mark.parametrize('fmt', ['json', 'yaml'])
def test_config_files_cross_both_ways(fmt, tmp_path):
    j, t = _both(CONFIGS[0])
    t.update(nested=tconfig.Config(a=[1, 2], b={'c': 0.5}))
    j.update(nested=jconfig.Config(a=[1, 2], b={'c': 0.5}))
    for writer, reader, name in ((t, jconfig.Config, 'port'), (j, tconfig.Config, 'jax')):
        fn = str(tmp_path / f'{name}.{fmt}')
        getattr(writer, f'to_{fmt}')(fn)
        back = getattr(reader, f'from_{fmt}')(fn)
        assert back.to_dict() == writer.to_dict() and back.hash() == writer.hash()


def test_schedule_matches_jax():
    scheds = []
    for lib in (jconfig, tconfig):
        s = lib.Schedule(lr=(1e-3, 1e-4), batch_size=(8, 16))
        s.add(momentum=(0.9, 0.99), conditions={'lr': 1e-3})
        s.add(warmup=5, conditions={'batch_size': (16,)})
        s.add(lr=1e-3)                        # a duplicate config is listed once
        scheds.append(s)
    js, ts = scheds
    assert len(ts) == len(js) == 6
    assert [c.to_dict() for c in ts] == [c.to_dict() for c in js]
    assert ts[2].to_dict() == js[2].to_dict() and isinstance(ts[0], tconfig.Config)
    assert [c.hash() for c in ts] == [c.hash() for c in js]


def test_conf2tweaks_rejects_what_the_jax_package_rejects():
    pm, jm, _ = _models(seed=1)
    for bad in ({'Conv2d': {'momentum': 0.1}}, {'BatchNorm2d': {'affine': False}}):
        with pytest.raises(ValueError):
            jconfig.conf2tweaks_(bad, jm)
        with pytest.raises(ValueError):
            tconfig.conf2tweaks_(bad, pm)


def _one_step(tweak, seed=6, jax_side=True):
    """One ``fit`` step of both trainers (or the port's alone); ``tweak`` is
    applied after they are built."""
    data = _dataset(2, seed=40)
    pm, jm, _ = _models(seed=seed)
    for m in pm.modules():
        if isinstance(m, Dropout2d):
            m.p = 0.

    def no_dropout(call, args, kwargs, context):
        if isinstance(context.module, flax.linen.Dropout):
            return args[0]
        return call(*args, **kwargs)

    jt = JTrainer(jm, optimizer=optax.adam(1e-3), log_fn=lambda *a: None, seed=5)
    tt = TTrainer(pm, optimizer={'Adam': {'lr': 1e-3}}, log_fn=lambda *a: None, seed=5)
    if tweak is not None:
        jconfig.conf2tweaks_(tweak, jm)
        tconfig.conf2tweaks_(tweak, pm)
        assert pm.tweaks == jm.tweaks
    tt.fit(data, epochs=1, batch_size=2, max_instances=16, samples=SAMPLES, prefetch=0)
    if not jax_side:
        return dict(pm.named_buffers()), None
    with flax.linen.intercept_methods(no_dropout):
        jt.fit(data, epochs=1, batch_size=2, max_instances=16, samples=SAMPLES, prefetch=0)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                      {'batch_stats': jm.variables['batch_stats']}))
    return dict(pm.named_buffers()), want


def test_conf2tweaks_momentum_moves_running_statistics_as_jax():
    tweak = {'BatchNorm2d': {'momentum': 0.05}}
    got, want = _one_step(tweak)
    assert want and set(want) <= set(got)
    for key, ref in want.items():
        ref = ref.numpy()
        atol = 1e-6 * max(1., float(np.abs(ref).max()))
        np.testing.assert_allclose(got[key].numpy(), ref, rtol=0, atol=atol, err_msg=key)
    plain, _ = _one_step(None, jax_side=False)
    moved = [k for k in want if k.endswith('running_mean')
             and not np.allclose(plain[k].numpy(), got[k].numpy(), rtol=0, atol=1e-7)]
    assert moved, 'the tweak did not change the running statistics'
