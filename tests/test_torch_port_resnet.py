"""Port parity: the ResNet-family CPNs (ResNet/ResNeXt/WideResNet UNets and FPNs).

The same numpy-seeded weights and inputs go through the JAX package on the
CPU and through ``celldetection_tpu_torch`` with ``device='cpu'``:

* weights of all twenty ``Cpn<ResNet>{UNet,FPN}``: ``state_dict_from_jax``
  equals the JAX package's ``export_torch_state_dict(encoder='resnet')`` key
  by key and value by value, loads with ``strict=True``, and the port's
  ``init_jax_variables`` gives the JAX package's variable tree back; the
  variable trees come from ``jax.eval_shape`` of ``core.init`` (no forward);
* fp32 forwards with ``_slice_parity``'s gates and tolerances (dense heads
  within 1e-4 of each map's peak, equal valid sets before and after NMS,
  equal classes, contours within 1e-3 px on 99% of points, mean under
  0.1 px): BasicBlock with one bridge and, with ``fused_initial=True``, two;
  grouped convolutions (ResNeXt50); the FPN with its ``'pool'`` level and
  the multiclass decode; and the flagship CpnResNeXt101UNet at base 8;
* a 5-D input through ResNet50 built with ``nd=3`` against the JAX
  package's encoder on the same weights (every level within 1e-4 of its peak).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celldetection_tpu import models as jmodels
from celldetection_tpu.models import resnet as jresnet
from celldetection_tpu.util.torch_import import export_torch_state_dict
from celldetection_tpu_torch import models as tmodels
from celldetection_tpu_torch.util import init_jax_variables, state_dict_from_jax
from test_torch_port_cpn import _numpy_tree, _slice_parity
from test_torch_port_cpn import one_torch_thread  # noqa: F401  (pytestmark)
from test_torch_port_commons import flax_variables, load_port

pytestmark = pytest.mark.usefixtures('one_torch_thread')

RESNETS = ('ResNet18', 'ResNet34', 'ResNet50', 'ResNet101', 'ResNet152', 'ResNeXt50',
           'ResNeXt101', 'ResNeXt152', 'WideResNet50', 'WideResNet101')
CPNS = [f'Cpn{r}{kind}' for r in RESNETS for kind in ('UNet', 'FPN')]


@pytest.mark.parametrize('name, fused_initial',
                         [(n, False) for n in CPNS] + [('CpnResNet18UNet', True)])
def test_state_dict_from_jax_matches_export_torch_state_dict(name, fused_initial):
    # base 16: ResNeXt50's narrowest grouped conv has 1 channel per group there
    bk = dict(base_channel=16)
    if fused_initial:
        bk['fused_initial'] = True
    jm = jmodels.get_cpn(name)(3, backbone_kwargs=dict(bk))
    shapes = jax.eval_shape(lambda: jm.core.init({'params': jax.random.PRNGKey(0)},
                                                 jnp.zeros((1, 64, 64, 3)), False))
    rng = np.random.RandomState(0)
    variables = _numpy_tree(jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(s.dtype), shapes))
    want = export_torch_state_dict(variables, fused_initial=fused_initial, encoder='resnet')
    got = state_dict_from_jax(variables, fused_initial=fused_initial)
    assert sorted(got) == sorted(want)
    assert [k for k, v in want.items() if not np.array_equal(got[k].numpy(), v)] == []
    pm = tmodels.get_cpn(name)(3, backbone_kwargs=dict(bk), device='cpu')
    assert pm.hparams['model'] == name
    assert sorted(pm.state_dict()) == sorted(want)
    pm.load_state_dict(got, strict=True)
    again = init_jax_variables(pm, 1)
    assert jax.tree_util.tree_map(np.shape, again) == jax.tree_util.tree_map(np.shape, variables)


def _tame(variables):
    """Keep random weights' outputs in range: scale the last norm of every
    residual branch (through many blocks the activations otherwise grow block
    by block until the score sigmoid saturates and leaves no gap for a
    threshold), and the refinement head's output layer (logits of some
    hundreds saturate ``3 tanh`` and hide the head's error in it)."""
    params = variables['params']
    for layer, blocks in params['backbone']['body'].items():
        if layer.startswith('layer'):
            for block in blocks.values():
                last = block['bn3' if 'bn3' in block else 'bn2']['norm']
                last.update({k: v * np.float32(0.1) for k, v in last.items()})
    out = params['refinement_head']['conv1']
    out.update({k: v * np.float32(0.01) for k, v in out.items()})


@pytest.mark.parametrize('name, backbone_kwargs, size, batch, capacity, seed, classes', [
    ('CpnResNet18UNet', None, 128, 2, 512, 0, 2),
    ('CpnResNet18UNet', dict(fused_initial=True), 128, 1, 512, 1, 2),
    ('CpnResNeXt50UNet', dict(base_channel=16), 64, 1, 256, 2, 2),
    ('CpnResNet18FPN', None, 128, 2, 1024, 3, 3),
    ('CpnResNeXt101UNet', dict(base_channel=8), 64, 1, 256, 4, 2),
])
def test_resnet_cpn_fp32_matches_jax(name, backbone_kwargs, size, batch, capacity, seed, classes):
    _slice_parity(name, backbone_kwargs, size, batch, capacity, seed, classes=classes,
                  scale_weights=_tame)


def test_resnet_options_raise_until_ported():
    """The options of later slices, ported since: ``pyramid_pooling``,
    ``pretrained`` and the ``MambaLayer`` secondary block are held in
    ``tests/test_torch_port_zoo.py``, ``tests/test_torch_port_pretrained.py``
    and ``tests/test_torch_port_mamba.py``; here the secondary block builds
    one layer per stage, and a 5-D input runs through the encoder built with
    ``nd=3`` as through the JAX package's (``tests/test_torch_port_nd.py``
    holds the rest of the 3-D models)."""
    body = tmodels.get_cpn('CpnResNet18UNet')(
        3, backbone_kwargs=dict(secondary_block=tmodels.MambaLayer, base_channel=8),
        device='cpu').core.backbone.body
    assert [type(getattr(body, f'secondary{i}')).__name__ for i in range(1, 5)] == \
        ['MambaLayer'] * 4
    jm = jresnet.ResNet50(3, fused_initial=False, base_channel=8)
    tm = tmodels.ResNet50(3, fused_initial=False, base_channel=8, nd=3)
    x = np.random.RandomState(0).rand(1, 8, 32, 32, 3).astype(np.float32)
    variables = flax_variables(jm, x, False, seed=0)
    load_port(tm, variables, ('backbone', 'body'), 'core.backbone.body.', fused_initial=False)
    ref = jax.jit(lambda v, x: jm.apply(v, x, False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x).movedim(-1, 1))
    assert sorted(got) == sorted(ref) == ['0', '1', '2', '3', '4']
    for key, value in ref.items():
        value = np.asarray(value)
        np.testing.assert_allclose(got[key].movedim(1, -1).numpy(), value, rtol=0,
                                   atol=1e-4 * float(np.abs(value).max()), err_msg=key)
