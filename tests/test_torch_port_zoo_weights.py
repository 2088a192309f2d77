"""Port parity: the weights of the rest of the CPN zoo, its files and its init.

The JAX package and ``celldetection_tpu_torch`` (``device='cpu'``) on the
same numpy-seeded weights:

* the port registers every name of the JAX package's ``models_by_name``;
* every one of the twenty constructors the port adds that needs no timm or
  smp (``CpnSlimU22``, ``CpnWideU22``, ``CpnU17``, ``CpnResUNet``, the
  ConvNeXt(V2), DenseNet and MobileNetV3 UNets, the MobileNetV3 FPNs and the
  ResNet MaNets), at full width: the JAX variable tree from ``jax.eval_shape``
  of ``core.init`` goes through ``state_dict_from_jax``, loads with
  ``strict=True``, comes back equal through ``jax_variables_from_state_dict``,
  and ``init_jax_variables`` gives the same tree. The files and the init of
  these families are ``tests/test_torch_port_zoo_files.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from celldetection_tpu import models as jmodels
from celldetection_tpu_torch import models as tmodels
from celldetection_tpu_torch.util import (init_jax_variables, jax_variables_from_state_dict,
                                          state_dict_from_jax)
from celldetection_tpu_torch.util.weights import body_layout

NATIVE = ('CpnSlimU22', 'CpnWideU22', 'CpnU17', 'CpnResUNet', 'CpnConvNeXtTinyUNet',
          'CpnConvNeXtSmallUNet', 'CpnConvNeXtBaseUNet', 'CpnConvNeXtLargeUNet',
          'CpnConvNeXtV2TinyUNet', 'CpnConvNeXtV2BaseUNet', 'CpnDenseNet121UNet',
          'CpnDenseNet161UNet', 'CpnDenseNet169UNet', 'CpnDenseNet201UNet',
          'CpnMobileNetV3LargeUNet', 'CpnMobileNetV3SmallUNet', 'CpnMobileNetV3LargeFPN',
          'CpnMobileNetV3SmallFPN', 'CpnResNet18MaNet', 'CpnResNet50MaNet')


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in dict(tree).items()}


def _jax_shapes(jm, in_channels=3, size=64):
    return jax.eval_shape(lambda: jm.core.init({'params': jax.random.PRNGKey(0)},
                                               jnp.zeros((1, size, size, in_channels)), False))


def test_every_jax_name_is_registered():
    assert sorted(tmodels.models_by_name) == sorted(jmodels.models_by_name)
    assert len(tmodels.models_by_name) == 47
    assert set(NATIVE) == set(tmodels.models_by_name) - {
        'CpnU22', 'CpnU12', 'CpnTimmUNet', 'CpnSmpUNet', 'CpnTimmMaNet', 'CpnSmpMaNet',
        'CpnMiTB5MaNet', *(f'Cpn{r}{k}' for r in (
            'ResNet18', 'ResNet34', 'ResNet50', 'ResNet101', 'ResNet152', 'ResNeXt50',
            'ResNeXt101', 'ResNeXt152', 'WideResNet50', 'WideResNet101') for k in ('UNet', 'FPN'))}


@pytest.mark.parametrize('name', NATIVE)
def test_full_width_weights_carry_both_ways(name):
    jm = jmodels.get_cpn(name)(3)
    shapes = _jax_shapes(jm)
    rng = np.random.default_rng(0)
    variables = _numpy_tree(jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape, dtype=np.float32), shapes))
    # no init draws: every parameter is replaced
    pm = tmodels.get_cpn(name)(3, device='cpu', torch_init=False)
    assert pm.hparams['model'] == name
    encoder, fused = body_layout(pm)
    assert fused == name.endswith('MaNet')     # the ResNet default, as in the JAX package
    sd = state_dict_from_jax(variables, fused_initial=fused)
    assert sorted(sd) == sorted(pm.state_dict())
    pm.load_state_dict(sd, strict=True)
    back = jax_variables_from_state_dict(pm.state_dict(), fused, encoder)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(variables)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, back, variables))
    again = init_jax_variables(pm, 1)
    assert jax.tree_util.tree_map(np.shape, again) == jax.tree_util.tree_map(np.shape, variables)
