"""Port parity: ImageNet encoder weights, and the timm and smp names.

The JAX package's ``util/pretrained.py`` and the port's on the same synthetic
torchvision-layout state dicts, built from a model's own variable tree as
``tests/test_pretrained.py`` builds them (seeded numpy values, a classifier
that must be dropped, a 3-channel first conv for a 1-channel model):

* ``adapt_first_conv`` (nearest over input channels) and the three
  translators (ResNet, DenseNet with the 2017 files' legacy key names,
  ConvNeXt with its Linear layers and layer scale) equal the JAX package's
  key by key and value by value;
* ``backbone_kwargs={'pretrained': ...}`` (a mapping, a local ``.pth``, or a
  URL found in torch.hub's cache) loads the same encoder as the JAX
  package's ``apply_pretrained_``, after the init, which the decoder and the
  heads keep; a URL outside the cache raises and names it, nothing is
  downloaded;
* the shape-mismatch, coverage and unknown-leaf errors;
* the Timm/Smp CPNs build the native encoder for a name of the native table
  (the same variable tree as the JAX package's) and raise ``ImportError``
  naming timm or smp for any other, as ``CpnMiTB5MaNet`` always does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from celldetection_tpu import models as jmodels
from celldetection_tpu.util import pretrained as jpre
from celldetection_tpu_torch import models as tmodels
from celldetection_tpu_torch.util import pretrained as tpre
from celldetection_tpu_torch.util import state_dict_from_jax
from celldetection_tpu_torch.util.weights import body_layout
from test_pretrained import _torchvision_layout_from_tree
from test_torch_port_cpn import one_torch_thread  # noqa: F401  (pytestmark)

pytestmark = pytest.mark.usefixtures('one_torch_thread')

LEAF = {('params', 'scale'): 'weight', ('params', 'bias'): 'bias',
        ('batch_stats', 'mean'): 'running_mean', ('batch_stats', 'var'): 'running_var'}


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in dict(tree).items()}


def _zero_variables(jm, in_channels, size=64):
    """The JAX model's variable tree as zeros (``jax.eval_shape``, no op-by-op init)."""
    shapes = jax.eval_shape(lambda: jm.core.init({'params': jax.random.PRNGKey(0)},
                                                 jnp.zeros((1, size, size, in_channels)), False))
    return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)


def _body_leaves(variables):
    for coll in variables:
        for path, v in flatten_dict(_numpy_tree(variables[coll])).items():
            if path[:2] == ('backbone', 'body'):
                yield coll, path[2:], v


def _densenet_layout(variables, rng, legacy=False):
    """A torchvision DenseNet state dict of the tree's shapes, conv0 with 3 channels."""
    sd = {}
    for coll, path, v in _body_leaves(variables):
        mods, leaf = path[:-1], path[-1]
        val = rng.randn(*v.shape).astype(np.float32)
        if leaf == 'kernel':
            if mods == ('conv0',):
                val = rng.randn(*v.shape[:2], 3, v.shape[3]).astype(np.float32)
            name = '.'.join(mods)
            if legacy and 'denselayer' in name:   # 'conv1' -> 'conv.1'
                name = name[:-1] + '.' + name[-1]
            sd[f'features.{name}.weight'] = np.transpose(val, (3, 2, 0, 1))
        else:   # <norm>/norm/<leaf>
            name = '.'.join(mods[:-1])
            if legacy and 'denselayer' in name:
                name = name[:-1] + '.' + name[-1]
            sd[f'features.{name}.{LEAF[(coll, leaf)]}'] = val
    sd['classifier.weight'] = rng.randn(1000, 8).astype(np.float32)
    return sd


def _convnext_layout(variables, rng):
    """A torchvision ConvNeXt state dict of the tree's shapes, the stem with 3 channels."""
    sd = {}
    for _, path, v in _body_leaves(variables):
        mod, leaf = path[0], path[-1]
        val = rng.randn(*v.shape).astype(np.float32)
        tv_leaf = 'weight' if leaf in ('scale', 'kernel') else 'bias'
        if mod.startswith('stem'):
            key = f'features.0.{0 if mod == "stem_conv" else 1}.{tv_leaf}'
            if leaf == 'kernel':
                val = rng.randn(4, 4, 3, v.shape[-1]).astype(np.float32)
        elif mod.startswith('down'):
            key = f'features.{2 * int(mod[4])}.{0 if mod.endswith("norm") else 1}.{tv_leaf}'
        else:
            stage, j = int(mod[5]), int(mod.split('block')[1])
            base = f'features.{2 * stage + 1}.{j}'
            if leaf == 'layer_scale':
                sd[f'{base}.layer_scale'] = val.reshape(-1, 1, 1)
                continue
            sub = path[1]
            key = f'{base}.block.{dict(dwconv=0, norm=2, mlp0=3, mlp1=5)[sub]}.{tv_leaf}'
            if leaf == 'kernel' and sub != 'dwconv':
                sd[key] = val.T
                continue
        sd[key] = np.transpose(val, (3, 2, 0, 1)) if leaf == 'kernel' else val
    sd['classifier.2.weight'] = rng.randn(1000, 768).astype(np.float32)
    return sd


def _resnet_layout(variables, rng):
    sd = _torchvision_layout_from_tree(_numpy_tree(variables), rng)
    sd['conv1.weight'] = rng.randn(*sd['conv1.weight'].shape[:1], 3,
                                   *sd['conv1.weight'].shape[2:]).astype(np.float32)
    return sd


CASES = {
    'resnet': ('CpnResNet18UNet', dict(base_channel=16), _resnet_layout,
               jpre.translate_torchvision_resnet, tpre.translate_torchvision_resnet),
    'densenet': ('CpnDenseNet121UNet', None, _densenet_layout,
                 jpre.translate_torchvision_densenet, tpre.translate_torchvision_densenet),
    'densenet_legacy': ('CpnDenseNet121UNet', None,
                        lambda v, rng: _densenet_layout(v, rng, legacy=True),
                        jpre.translate_torchvision_densenet, tpre.translate_torchvision_densenet),
    'convnext': ('CpnConvNeXtTinyUNet', None, _convnext_layout,
                 jpre.translate_torchvision_convnext, tpre.translate_torchvision_convnext),
}


def test_adapt_first_conv_matches_jax():
    k = np.random.RandomState(0).randn(4, 3, 2, 2).astype(np.float32)
    for c in (1, 2, 3, 6, 7):
        np.testing.assert_array_equal(tpre.adapt_first_conv(k, c), jpre.adapt_first_conv(k, c))
    np.testing.assert_array_equal(tpre.adapt_first_conv(k, 6), k[:, [0, 0, 1, 1, 2, 2]])


@pytest.mark.parametrize('case', sorted(CASES))
def test_translators_match_jax(case):
    name, bk, layout, jtrans, ttrans = CASES[case]
    jm = jmodels.get_cpn(name)(1, backbone_kwargs=bk)
    sd = layout(_zero_variables(jm, 1), np.random.RandomState(1))
    if case == 'densenet_legacy':
        assert any('.norm.1.' in k for k in sd)
    want, got = jtrans(sd, in_channels=1), ttrans(sd, in_channels=1)
    assert sorted(got) == sorted(want)
    for key, v in want.items():
        np.testing.assert_array_equal(got[key], np.asarray(v), err_msg=str(key))
    with pytest.raises(KeyError):
        ttrans({'foo.bar': np.zeros(1)})


@pytest.mark.parametrize('case, source', [('resnet', 'mapping'), ('densenet', 'pth'),
                                          ('convnext', 'hub')])
def test_pretrained_cpn_matches_jax(tmp_path, monkeypatch, case, source):
    name, bk, layout, _, _ = CASES[case]
    jm = jmodels.get_cpn(name)(1, backbone_kwargs=bk)
    jm.variables = _zero_variables(jm, 1)
    sd = layout(jm.variables, np.random.RandomState(2))
    jm.hparams['model'] = name
    jpre.apply_pretrained_(jm, sd)
    spec = sd
    if source == 'pth':
        spec = str(tmp_path / 'encoder.pth')
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, spec)
    elif source == 'hub':   # a URL resolves through torch.hub's cache alone
        url = tpre.DEFAULT_MODEL_URLS['ConvNeXtTiny']
        monkeypatch.setattr(torch.hub, 'get_dir', lambda: str(tmp_path))
        with pytest.raises(FileNotFoundError, match=url):
            tmodels.get_cpn(name)(1, backbone_kwargs=dict(pretrained=True), device='cpu')
        (tmp_path / 'checkpoints').mkdir()
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   str(tmp_path / 'checkpoints' / url.rsplit('/', 1)[-1]))
        spec = True
    # the same init on both (torch's global generator draws the modules torch_init_ keeps)
    kw = dict(backbone_kwargs=dict(bk or {}), device='cpu', seed=4)
    torch.manual_seed(4)
    plain = tmodels.get_cpn(name)(1, **kw)
    kw['backbone_kwargs']['pretrained'] = spec
    torch.manual_seed(4)
    pm = tmodels.get_cpn(name)(1, **kw)
    assert 'pretrained' not in pm.hparams['backbone_kwargs']
    _, fused = body_layout(pm)
    want = state_dict_from_jax(_numpy_tree(jm.variables), fused)
    got = pm.state_dict()
    body = [k for k in got if k.startswith('core.backbone.body.')]
    assert body
    for k in got:
        ref = want[k] if k in body else plain.state_dict()[k]   # decoder and heads: the init
        assert torch.equal(got[k], ref), k


def test_pretrained_errors():
    name, bk, layout, _, _ = CASES['resnet']
    jm = jmodels.get_cpn(name)(3, backbone_kwargs=bk)
    sd = layout(_zero_variables(jm, 3), np.random.RandomState(3))

    def build(d):
        return tmodels.get_cpn(name)(3, backbone_kwargs=dict(bk, pretrained=d), device='cpu')

    bad = dict(sd)
    bad['layer1.0.conv1.weight'] = bad['layer1.0.conv1.weight'][:, :8]
    with pytest.raises(ValueError, match='shape mismatch'):
        build(bad)
    with pytest.raises(ValueError, match='shape mismatch'):
        jpre.apply_pretrained_(_with_variables(jm), bad)
    missing = dict(sd)
    del missing['layer2.0.conv2.weight']
    with pytest.raises(KeyError, match='not covered'):
        build(missing)
    extra = dict(sd)
    extra['layer5.0.conv1.weight'] = sd['layer4.0.conv1.weight']
    with pytest.raises(KeyError, match='not in model'):
        build(extra)
    with pytest.raises(ValueError, match='No pretrained weights known'):
        tmodels.get_cpn('CpnMobileNetV3LargeUNet')(3, backbone_kwargs=dict(pretrained=True),
                                                   device='cpu')


def _with_variables(jm):
    jm.variables = _zero_variables(jm, 3)
    return jm


@pytest.mark.parametrize('name, model_name, native', [
    ('CpnTimmUNet', 'resnet18', 'ResNetEncoder'),
    ('CpnSmpUNet', 'timm-mobilenetv3_small_100', 'MobileNetV3Encoder'),
    ('CpnTimmMaNet', 'densenet121', 'DenseNetEncoder'),
    ('CpnSmpMaNet', 'tu-convnextv2_tiny', 'ConvNeXtEncoder'),
])
def test_timm_smp_names_resolve_native(name, model_name, native):
    pm = tmodels.get_cpn(name)(3, model_name=model_name, device='cpu', torch_init=False)
    assert type(pm.core.backbone.body).__name__ == native
    assert pm.hparams['model'] == name and pm.hparams['model_name'] == model_name
    jm = jmodels.get_cpn(name)(3, model_name=model_name)
    _, fused = body_layout(pm)
    sd = state_dict_from_jax(_numpy_tree(_zero_variables(jm, 3)), fused)
    pm.load_state_dict(sd, strict=True)


@pytest.mark.parametrize('name, model_name, package', [
    ('CpnTimmUNet', 'efficientnet_b0', 'timm'), ('CpnTimmMaNet', 'regnety_016', 'timm'),
    ('CpnSmpUNet', 'mit_b2', 'smp'), ('CpnSmpMaNet', 'efficientnet-b4', 'smp'),
    ('CpnTimmUNet', 'resnet18', 'timm'),     # force_host skips the native encoder
])
def test_timm_smp_missing_raise_import_error(name, model_name, package):
    bk = dict(force_host=True) if model_name == 'resnet18' else None
    with pytest.raises(ImportError, match=package):
        tmodels.get_cpn(name)(3, model_name=model_name, backbone_kwargs=bk, device='cpu')


def test_mit_b5_manet_needs_smp():
    with pytest.raises(ImportError, match='smp'):
        tmodels.CpnMiTB5MaNet(3, device='cpu')
