"""Port parity: 3-D (``nd=3``) backbones and the 5-D resizes.

The JAX package infers every block's spatial rank from its input; the port
builds ``Conv3d``, 3-D pools and norms when a module gets ``nd=3``. The same
numpy-seeded weights and NCDHW/NDHWC volumes of 12^3-32^3 go through both on
the CPU, fp32: the flax variables (``test_torch_port_commons.fill``) through
``state_dict_from_jax`` (DHWIO kernels to OIDHW) into the port's module with
``strict=True`` and back; every output map within 1e-4 of its peak:

* ``interpolate_nchw``/``resize_bilinear``/``resize_nearest``/``equal_size``
  on 5-D tensors against ``jax.image.resize`` (trilinear up, antialiased
  down, mixed) and the JAX package's nearest rule;
* U22 and a ``BottleneckBlock`` U-Net, the ResNet18 and ResNeXt50 UNets
  (stride bridging, ``groups=32``), the ResNet18 FPN (its ``pool`` level),
  a ResNet encoder with ``MambaLayer`` after each stage and ``Ppm``, narrow
  ConvNeXt and DenseNet encoders, MobileNetV3Small, ``Ppm``, the MaNet
  blocks (PAB and MFAB) and a MaNet over a 3-D ResNet18;
* the shapes of ``tests/test_models_extra.py``'s 3-D tests at full width
  (U22, ResNet18 UNet and FPN, ConvNeXtTiny, MobileNetV3Small at 16^3;
  DenseNet121 at 32^3, where every level is non-empty);
* ``get_cpn(..., backbone_kwargs={'nd': 3})`` raises a ``ValueError``: the
  CPN decode is 2-D in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celldetection_tpu import models as jmodels
from celldetection_tpu.models import convnext as jconvnext
from celldetection_tpu.models import densenet as jdensenet
from celldetection_tpu.models import manet as jmanet
from celldetection_tpu.models import mobilenetv3 as jmnv3
from celldetection_tpu.models import ppm as jppm
from celldetection_tpu.models import resnet as jresnet
from celldetection_tpu.models import unet as junet
from celldetection_tpu.models.commons import BottleneckBlock as JBottleneck
from celldetection_tpu.ops import commons as jops
from celldetection_tpu_torch import models as tmodels
from celldetection_tpu_torch import ops as tops
from celldetection_tpu_torch.models import unet as tunet
from test_torch_port_commons import channels_last, flax_variables, load_port
from test_torch_port_cpn import one_torch_thread  # noqa: F401  (pytestmark)

pytestmark = pytest.mark.usefixtures('one_torch_thread')


def volume(seed, side, channels=1, batch=1):
    return np.random.RandomState(seed).rand(batch, side, side, side, channels).astype(np.float32)


def peak_close(port, ref, tol=1e-4):
    """Every map of ``port`` (NC... tensors, or a dict of them) within ``tol``
    of the peak of the JAX package's (N...C) map."""
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref)
        for key in ref:
            peak_close(port[key], ref[key], tol)
        return
    ref = np.asarray(ref)
    got = channels_last(port)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(float(np.abs(ref).max()), 1e-30))


def parity(jmod, tmod, x, path, prefix, *args, seed=0, fused_initial=False):
    """``jmod`` and ``tmod`` on the same flax variables and NDHWC ``x``."""
    variables = flax_variables(jmod, x, *args, False, seed=seed)
    load_port(tmod, variables, path, prefix, fused_initial)
    ref = jax.jit(lambda v, x, *a: jmod.apply(v, x, *a, False))(
        variables, jnp.asarray(x), *[jnp.asarray(a) for a in args])
    tmod.eval()
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).movedim(-1, 1),
                   *[torch.from_numpy(a).movedim(-1, 1) for a in args])
    peak_close(got, ref)
    return got


BACKBONE = (('backbone',), 'core.backbone.')
BODY = (('backbone', 'body'), 'core.backbone.body.')


# -- 5-D resizes -------------------------------------------------------------

@pytest.mark.parametrize('size', [(7, 9, 11), (3, 4, 2), (9, 3, 5), (5, 5, 5)])
def test_resize_5d_matches_jax(size):
    x = np.random.RandomState(1).randn(2, 5, 6, 5, 3).astype(np.float32)
    xt = torch.from_numpy(x)
    ref = jops.resize_bilinear(jnp.asarray(x), size)
    np.testing.assert_allclose(tops.resize_bilinear(xt, size).numpy(), ref, rtol=0, atol=2e-6)
    np.testing.assert_array_equal(tops.resize_nearest(xt, size).numpy(),
                                  jops.resize_nearest(jnp.asarray(x), size))
    ref_like = torch.zeros((1,) + size + (1,))
    np.testing.assert_allclose(tops.equal_size(xt, ref_like).numpy(), ref, rtol=0, atol=2e-6)
    nchw = tops.interpolate_nchw(xt.movedim(-1, 1), size, 'trilinear')
    np.testing.assert_allclose(channels_last(nchw), ref, rtol=0, atol=2e-6)


# -- the U-Net family ---------------------------------------------------------

def test_u22_3d_matches_jax():
    x = volume(2, 16)
    jm = junet.U22(1, 2, backbone_kwargs=dict(base_channels=8))
    tm = tmodels.U22(1, 2, nd=3, backbone_kwargs=dict(base_channels=8))
    assert isinstance(tm.body[1][0], torch.nn.MaxPool3d)
    assert tuple(parity(jm, tm, x, *BACKBONE, seed=2).shape) == (1, 2, 16, 16, 16)


def test_bottleneck_unet_3d_matches_jax():
    x = volume(3, 12)
    jm = junet._make_encoder_unet(1, 3, 4, 3, block_cls=JBottleneck)
    tm = tunet._make_encoder_unet(1, 3, 4, 3, block_cls=tmodels.BottleneckBlock, nd=3)
    assert isinstance(tm.body[0].block1.conv, torch.nn.Conv3d)
    parity(jm, tm, x, *BACKBONE, seed=3)


@pytest.mark.parametrize('name, kw', [('ResNet18UNet', dict(base_channel=8)),
                                      ('ResNeXt50UNet', dict(base_channel=16))])
def test_resnet_unet_3d_matches_jax(name, kw):
    x = volume(4, 16)
    jm = getattr(junet, name)(1, out_channels=4, backbone_kwargs=kw)
    tm = getattr(tmodels, name)(1, out_channels=4, nd=3, backbone_kwargs=kw)
    parity(jm, tm, x, *BACKBONE, seed=4)


def test_resnet_fpn_3d_matches_jax():
    x = volume(5, 16)
    jm = jmodels.ResNet18FPN(1, 16, backbone_kwargs=dict(base_channel=8))
    tm = tmodels.ResNet18FPN(1, 16, backbone_kwargs=dict(base_channel=8, nd=3))
    out = parity(jm, tm, x, *BACKBONE, seed=5)
    assert tuple(out['0'].shape) == (1, 16, 8, 8, 8) and tuple(out['pool'].shape[2:]) == (1,) * 3


def test_resnet_encoder_mamba_and_ppm_3d_match_jax():
    """``MambaLayer`` after each stage flattens all three spatial axes, as the JAX one does."""
    x = volume(6, 16)
    kw = dict(in_channels=1, layers=(1, 1, 1, 1), base_channel=8, pyramid_pooling=True,
              pyramid_pooling_channels=4)
    jm = jresnet.ResNetEncoder(secondary_block=jmodels.MambaLayer, **kw)
    tm = tmodels.ResNetEncoder(secondary_block=tmodels.MambaLayer, nd=3, **kw)
    parity(jm, tm, x, *BODY, seed=6, fused_initial=True)


# -- ConvNeXt, DenseNet, MobileNetV3, Ppm, MaNet ------------------------------

def test_convnext_and_densenet_3d_match_jax():
    x = volume(7, 32)
    out = parity(jconvnext.ConvNeXtEncoder(in_channels=1, depths=(2, 2), channels=(16, 32)),
                 tmodels.ConvNeXtEncoder(1, depths=(2, 2), channels=(16, 32), nd=3),
                 x, *BODY, seed=7)
    assert tuple(out['1'].shape) == (1, 32, 4, 4, 4)
    kw = dict(in_channels=1, growth_rate=8, block_config=(2, 2), init_features=8)
    out = parity(jdensenet.DenseNetEncoder(**kw), tmodels.DenseNetEncoder(nd=3, **kw),
                 x, *BODY, seed=8)
    assert [tuple(v.shape[2:]) for v in out.values()] == [(8, 8, 8), (4, 4, 4)]


def test_mobilenetv3_3d_matches_jax():
    x = volume(9, 16)
    out = parity(jmnv3.MobileNetV3Small(1, width_mult=0.5), tmodels.MobileNetV3Small(
        1, width_mult=0.5, nd=3), x, *BODY, seed=9)
    assert tuple(out['0'].shape[2:]) == (8, 8, 8) and tuple(out['1'].shape[2:]) == (4, 4, 4)


def test_ppm_and_manet_blocks_3d_match_jax():
    x = volume(10, 12, channels=8)
    out = parity(jppm.Ppm(out_channels=4, scales=(1, 2, 3, 5)),
                 tmodels.Ppm(8, 4, scales=(1, 2, 3, 5), nd=3),
                 x, ('backbone', 'body', 'ppm'), 'core.backbone.body.ppm.', seed=10)
    assert tuple(out.shape) == (1, 8 + 4 * 4, 12, 12, 12)
    x = volume(11, 4, channels=8, batch=2)
    parity(jmanet.PositionWiseAttention(mid_channels=4, beta=True),
           tmodels.PositionWiseAttention(8, mid_channels=4, beta=True, nd=3),
           x, ('backbone', 'decoder', 'pab'), 'core.backbone.decoder.pab.', seed=11)
    lateral = volume(12, 8, channels=6, batch=2)
    out = parity(jmanet.MultiscaleFusionAttention(out_channels=5, lateral_channels=6),
                 tmodels.MultiscaleFusionAttention(8, 5, 6, nd=3),
                 x, ('backbone', 'decoder', 'mfab0'), 'core.backbone.decoder.mfab0.', lateral,
                 seed=12)
    assert tuple(out.shape) == (2, 5, 8, 8, 8)


def test_manet_3d_matches_jax():
    """The whole MA-Net over a 3-D ResNet18: the PAB on the deepest level, MFABs
    top-down, the finest level resized trilinearly to the input."""
    x = volume(13, 32)
    jm = jmanet.MaNet(body=jresnet.ResNet18(1, base_channel=8), pab_channels=8)
    tm = tmodels.MaNet(tmodels.ResNet18(1, base_channel=8, nd=3), pab_channels=8, nd=3)
    out = parity(jm, tm, x, *BACKBONE, seed=13, fused_initial=True)
    assert tuple(out['out'].shape) == (1, 8, 32, 32, 32)


# -- shapes at full width, and the CPN's refusal -------------------------------

def test_full_width_3d_shapes():
    """``tests/test_models_extra.py``'s 3-D shapes, at the constructors' own widths."""
    x = torch.zeros(1, 1, 16, 16, 16)
    with torch.no_grad():
        assert tuple(tmodels.U22(1, 2, nd=3)(x).shape) == (1, 2, 16, 16, 16)
        assert tuple(tmodels.ResNet18UNet(1, out_channels=4, nd=3)(x).shape) == \
            (1, 4, 16, 16, 16)
        feats = tmodels.ResNet18FPN(1, nd=3)(x)
        assert tuple(feats['0'].shape) == (1, 256, 8, 8, 8)
        assert tuple(feats['pool'].shape[2:]) == (1, 1, 1)
        assert tuple(tmodels.ConvNeXtTiny(1, nd=3)(x)['0'].shape[2:]) == (4, 4, 4)
        # at 16^3 the JAX package's last transition pools 1^3 to an empty map, torch's raises
        dense = tmodels.DenseNet121(1, nd=3)(torch.zeros(1, 1, 32, 32, 32))
        assert [tuple(v.shape[2:]) for v in dense.values()] == [(8,) * 3, (4,) * 3, (2,) * 3,
                                                                (1,) * 3]
        feats = tmodels.MobileNetV3Small(1, nd=3)(x)
        assert tuple(feats['0'].shape[2:]) == (8, 8, 8) and tuple(feats['1'].shape[2:]) == (4,) * 3


@pytest.mark.parametrize('name', ['CpnU22', 'CpnResNet50UNet', 'CpnResNet18FPN',
                                  'CpnTimmUNet'])
def test_cpn_refuses_3d_backbones(name):
    kw = dict(model_name='resnet18') if 'Timm' in name else {}
    with pytest.raises(ValueError, match='2-D'):
        tmodels.get_cpn(name)(1, device='cpu', backbone_kwargs={'nd': 3}, **kw)
