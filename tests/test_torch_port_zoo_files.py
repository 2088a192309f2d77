"""Port parity: cdt files and the init of the rest of the CPN zoo.

The JAX package and ``celldetection_tpu_torch`` (``device='cpu'``) on the
same numpy-seeded weights:

* cdt files both ways with the JAX package, one model of each family
  (ResUNet, ConvNeXtV2 with GRN, DenseNet, MobileNetV3 FPN, ResNet MaNet):
  the port's file loads in the JAX package's ``load_model``, and the JAX
  package's file in the port's, weights bit-equal. ``load_model`` restores
  the file's bytes into the variable tree of ``CPN.init``, which runs op by
  op on the CPU (20 s for DenseNet121); the tests give it that tree as the
  zeros of ``jax.eval_shape`` of the same ``core.init``;
* ``torch_init_``'s schemes for the new families against the JAX package's
  ``torch_init_variables``: the same scheme for every kernel (ConvNeXt's
  ``Dense`` kernels included), zero biases, and by distribution, since the
  draws cannot be equal (``jax.random`` against a ``torch.Generator``): each
  scheme's standard deviation over the encoder within 3% of the JAX draw's
  and of the scheme's own, means within 0.02, and ConvNeXt's truncation at
  two standard deviations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celldetection_tpu import models as jmodels
from celldetection_tpu import util as jutil
from celldetection_tpu.models import cpn as jcpn
from celldetection_tpu.util import init as jinit
from celldetection_tpu_torch import models as tmodels
from celldetection_tpu_torch.util import init as tinit
from celldetection_tpu_torch.util import serialization as tser
from celldetection_tpu_torch.util import init_jax_variables, state_dict_from_jax
from celldetection_tpu_torch.util.weights import body_layout
from test_torch_port_zoo_weights import _jax_shapes, _numpy_tree


# one model of each family, narrow where its constructor takes a width
_FILES = {
    'CpnResUNet': dict(backbone_kwargs=dict(base_channels=8)),
    'CpnConvNeXtV2TinyUNet': {},
    'CpnDenseNet121UNet': {},
    'CpnMobileNetV3SmallFPN': dict(backbone_kwargs=dict(width_mult=0.5)),
    'CpnResNet18MaNet': dict(backbone_kwargs=dict(base_channel=16)),
}


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k].cpu(), torch.as_tensor(v)), k


def _template_init(self, rng=None, input_shape=(1, 256, 256, 3)):
    """``CPN.init``'s variable tree as zeros: every leaf is replaced by the file's."""
    shapes = _jax_shapes(self, input_shape[-1], input_shape[1])
    self.variables = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    return self.variables


@pytest.mark.parametrize('name', sorted(_FILES))
def test_cdt_files_both_ways(tmp_path, monkeypatch, name):
    monkeypatch.setattr(jcpn.CPN, 'init', _template_init)
    kw = dict(_FILES[name], max_detections=64, samples=8)
    pm = tmodels.get_cpn(name)(3, device='cpu', **kw)
    _, fused = body_layout(pm)
    variables = init_jax_variables(pm, 5)
    pm.load_state_dict(state_dict_from_jax(variables, fused), strict=True)
    pm.score_thresh = 0.61
    fn = str(tmp_path / 'port.cdt')
    tser.save_model(fn, pm)
    jm = jutil.load_model(fn, input_shape=(1, 32, 32, 3))
    assert jm.hparams['model'] == name and jm.score_thresh == 0.61
    _assert_state_equal(state_dict_from_jax(_numpy_tree(jm.variables), fused), pm.state_dict())
    fn2 = str(tmp_path / 'jax.cdt')
    jm = jmodels.get_cpn(name)(3, **kw)   # weights set without the JAX package's init
    jm.variables = jax.tree_util.tree_map(lambda a: a * 2, variables)
    jutil.save_model(fn2, jm)
    again = tser.load_model(fn2, device='cpu')
    _assert_state_equal(again.state_dict(),
                        {k: v * 2 if v.is_floating_point() else v
                         for k, v in pm.state_dict().items()})


def _jax_kernel_paths(tree, path=()):
    out = []
    if 'kernel' in tree:
        out.append(path)
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _jax_kernel_paths(v, path + (k,))
    return out


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


@pytest.mark.parametrize('name, family, scheme', [
    ('CpnConvNeXtTinyUNet', 'convnext', 'trunc_normal_02'),
    ('CpnDenseNet121UNet', 'densenet', 'kaiming_normal_fan_in'),
    ('CpnMobileNetV3SmallUNet', 'mobilenetv3', 'kaiming_normal_fan_out'),
])
def test_torch_init_schemes_match_jax_by_distribution(name, family, scheme):
    jm = jmodels.get_cpn(name)(3)
    shapes = _jax_shapes(jm, size=32)
    assert jinit.detect_encoder_family(jm.core.backbone) == family
    want = {p: jinit._resolve_scheme(p, family) for p in _jax_kernel_paths(shapes['params'])}
    pm = tmodels.get_cpn(name)(3, device='cpu', seed=3)
    assert tinit.detect_encoder_family(pm.core.backbone) == family
    schemes = tinit.module_schemes(pm)
    assert {path: s for path, s in schemes.values()} == want
    body = [p for p, s in want.items() if s == scheme]
    assert body and all(p[:2] == ('backbone', 'body') for p in body)
    if family == 'convnext':   # the MLPs' Dense kernels are re-drawn too
        assert ('backbone', 'body', 'stage2_block8', 'mlp1') in body
    # JAX's draws over the same tree, from a zero tree of the same shapes
    zeros = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    jvars = jax.jit(lambda z: jinit.torch_init_variables(z, jax.random.PRNGKey(0), family))(zeros)
    sd = pm.state_dict()
    modules = {path: n for n, (path, _) in schemes.items()}
    got, ref = [], []
    for path in body:
        w = sd[f'{modules[path]}.weight']
        fan = w[0].numel() if scheme != 'kaiming_normal_fan_out' else w.shape[0] * w[0, 0].numel()
        std = 0.02 if scheme == 'trunc_normal_02' else np.sqrt(2. / fan)
        got.append(w.numpy().ravel() / std)
        ref.append(np.asarray(_get(jvars['params'], path)['kernel']).ravel() / std)
        bias = sd.get(f'{modules[path]}.bias')
        assert bias is None or not bias.any(), path
    got, ref = np.concatenate(got), np.concatenate(ref)
    assert got.size > 10 ** 5
    # both unit normals (truncated at 2 for ConvNeXt, whose std is then 0.88)
    unit = 0.8796 if scheme == 'trunc_normal_02' else 1.
    assert abs(got.std() / ref.std() - 1) < 0.03 and abs(got.std() / unit - 1) < 0.03
    assert abs(got.mean()) < 0.02 and abs(ref.mean()) < 0.02
    if scheme == 'trunc_normal_02':
        assert np.abs(got).max() <= 2. and np.abs(ref).max() <= 2.
    else:
        assert np.abs(got).max() > 3.
