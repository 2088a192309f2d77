"""Port parity: the forwards of the rest of the CPN zoo.

The same numpy-seeded weights and inputs go through the JAX package on the
CPU and through ``celldetection_tpu_torch`` with ``device='cpu'``:

* fp32 ``forward_padded`` through ``_slice_parity``'s gates (dense heads
  within 1e-4 of each map's peak, equal valid sets before and after NMS,
  contours within 1e-3 px on 99% of points): ConvNeXt at a side the strides
  do not divide (flax's 'SAME' padding of the 4x4/4 stem and the 2x2/2
  downsamples), ConvNeXtV2 with GRN, DenseNet, MobileNetV3 (Large, and Small
  with ``reduced_tail``, ``dilated`` and ``width_mult``), the MobileNetV3
  FPN, MaNet (PAB and MFAB), ResUNet, U17 and ``Ppm`` through
  ``ResNetEncoder(pyramid_pooling=True)`` at a side whose pooling windows
  leave a remainder; narrow encoders through the generic ``_make_cpn`` of
  each package, and one full-width registered constructor per family at
  64^2;
* bf16 compute of a ConvNeXtV2 CPN with the detection-level gates of
  ``test_cpn_u12_trained_bf16_matches_jax``, before NMS (see the test);
* ``Norm`` in each kind against flax (layer norm over the channels at eps
  1e-5, group norm with ``min(32, C)`` groups and instance norm at eps 1e-6):
  within 1e-5 of the output's magnitude, which covers flax's one-pass
  variance ``E[x^2] - E[x]^2`` against torch's two passes;
* training: ``tests/test_torch_port_zoo_train.py``.

Random weights hide a branch behind the identity where its leaves start near
zero: ``init_jax_variables`` gives ConvNeXt's layer scale values of 0.05-0.15
and GRN's gamma and beta 0.25-0.75; MobileNetV3's residual branches are
scaled down as the ResNets' are (``_tame``), else the activations grow block
by block until the score sigmoid saturates.
"""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celldetection_tpu.models import commons as jcommons
from celldetection_tpu.models import convnext as jconvnext
from celldetection_tpu.models import cpn as jcpn
from celldetection_tpu.models import densenet as jdensenet
from celldetection_tpu.models import unet as junet
from celldetection_tpu.ops.boxes import box_iou
from celldetection_tpu_torch.models import commons as tcommons
from celldetection_tpu_torch.models import convnext as tconvnext
from celldetection_tpu_torch.models import cpn as tcpn
from celldetection_tpu_torch.models import densenet as tdensenet
from celldetection_tpu_torch.models import unet as tunet
from celldetection_tpu_torch.util import init_jax_variables, state_dict_from_jax
from test_torch_port_cpn import _slice_parity
from test_torch_port_cpn import one_torch_thread  # noqa: F401  (pytestmark)

pytestmark = pytest.mark.usefixtures('one_torch_thread')


def _tame(variables):
    """Residual branches of random ResNet and MobileNetV3 bodies scaled by 0.1
    (their last norm), and the refinement head's output by 0.01 (logits of
    some hundreds saturate ``3 tanh`` and hide the head's error in it)."""
    params = variables['params']
    for name, block in params['backbone']['body'].items():
        if name.startswith('layer'):
            for b in block.values():
                last = b['bn3' if 'bn3' in b else 'bn2']['norm']
                last.update({k: v * np.float32(0.1) for k, v in last.items()})
        elif name.startswith('block') and 'project_bn' in block:
            last = block['project_bn']['norm']
            last.update({k: v * np.float32(0.1) for k, v in last.items()})
    out = params['refinement_head']['conv1']
    out.update({k: v * np.float32(0.01) for k, v in out.items()})


def _pair(jax_encoder, port_encoder):
    """Zoo-style constructors of a CPN over a UNet of the given encoders, one per package."""
    jfn, pfn = junet._backbone_unet(jax_encoder), tunet._backbone_unet(port_encoder)

    def jctor(in_channels, backbone_kwargs=None, **kw):
        return jcpn._make_cpn(jfn, in_channels, backbone_kwargs, **kw)

    def pctor(in_channels, backbone_kwargs=None, **kw):
        return tcpn._make_cpn(pfn, in_channels, backbone_kwargs, **kw)
    return jctor, pctor


def _convnext(v2=False, depths=(1, 1, 2, 1), channels=(16, 24, 32, 48)):
    def make(lib):
        return lambda in_channels, **kw: lib.ConvNeXtEncoder(in_channels=in_channels,
                                                             depths=depths, channels=channels,
                                                             v2=v2, **kw)
    return _pair(make(jconvnext), make(tconvnext))


def _densenet():
    def make(lib):
        return lambda in_channels, **kw: lib.DenseNetEncoder(
            in_channels=in_channels, growth_rate=8, block_config=(2, 3, 2, 2), init_features=16)
    return _pair(make(jdensenet), make(tdensenet))


@pytest.mark.parametrize('name, backbone_kwargs, size, batch, capacity, seed', [
    # 70 = 4 * 17 + 2: the stem pads 1 + 1, the last downsample 0 + 1
    ('convnext', None, 70, 2, 512, 0),
    ('convnext_v2', dict(fused_initial=False), 64, 1, 512, 1),
    ('densenet', None, 64, 2, 512, 2),
    ('CpnMobileNetV3LargeUNet', None, 64, 1, 512, 3),
    ('CpnMobileNetV3SmallUNet', dict(reduced_tail=True, dilated=True, width_mult=0.75), 64, 1,
     512, 4),
    ('CpnMobileNetV3SmallFPN', None, 128, 1, 512, 5),
    ('CpnResNet18MaNet', dict(base_channel=16), 128, 2, 512, 6),
    ('CpnResUNet', dict(base_channels=8), 64, 2, 512, 7),
    ('CpnU17', dict(base_channels=8), 64, 1, 512, 8),
    # 160: the deepest level is 5 x 5, so the pools of scales 2 and 3 leave a remainder
    ('CpnResNet18UNet', dict(base_channel=16, pyramid_pooling=True,
                             pyramid_pooling_channels=8), 160, 1, 1024, 9),
])
def test_zoo_fp32_matches_jax(name, backbone_kwargs, size, batch, capacity, seed):
    ctors = {'convnext': _convnext(), 'convnext_v2': _convnext(v2=True),
             'densenet': _densenet()}
    _slice_parity(ctors.get(name, name), backbone_kwargs, size, batch, capacity, seed,
                  scale_weights=_tame)


@pytest.mark.parametrize('name', ['CpnConvNeXtTinyUNet', 'CpnDenseNet121UNet',
                                  'CpnResNet18MaNet'])
def test_zoo_full_width_fp32_matches_jax(name):
    _slice_parity(name, None, 64, 1, 256, 10, scale_weights=_tame)


def test_convnext_v2_bf16_matches_jax():
    """bf16 compute of a ConvNeXtV2 CPN (LayerNorms, GRN's spatial sum, GELU in
    bf16 on the JAX side; torch's CPU kernels accumulate LayerNorm and sums in
    fp32) against the JAX package at fp32 and at bf16, with the gates of
    ``test_cpn_u12_trained_bf16_matches_jax`` (counts within 8%, 92% of the
    reference's boxes matched at IoU 0.8, their scores within 2.5e-2, their
    contours within 0.5 px on average).

    The gates are applied to the detections before NMS. A random network's
    scores are not peaked, so its NMS chooses among near-equal neighbours, and
    any rounding changes the choice: the JAX package's own bf16 matches only
    82-87% of its fp32 kept boxes on this model. NMS itself runs in fp32
    after the decode, and the fp32 tests hold the kept sets. The score head
    is rescaled and shifted so that the widest gap of the fp32 logits between
    ranks 60 and 200 falls on logit 16.5, the threshold: the selected scores
    are saturated, as a trained model's are. Outlines are kept small and near
    their pixels (Fourier and location outputs scaled down)."""
    jctor, pctor = _convnext(v2=True, depths=(1, 1, 2, 1), channels=(16, 32, 48, 64))
    kw = dict(in_channels=3, max_detections=512, samples=32)
    pm = pctor(device='cpu', compute_dtype=torch.bfloat16, **kw)
    variables = init_jax_variables(pm, 11)
    params = variables['params']
    _tame(variables)
    x_np = np.random.RandomState(11).rand(1, 256, 256, 3).astype(np.float32)
    x = jnp.asarray(x_np)
    runs = {}
    for dtype in (None, jnp.bfloat16):
        jm = jctor(compute_dtype=dtype, **kw)
        runs[dtype] = jax.jit(lambda v, x, t, jm=jm: jm.forward_padded(v, x, score_thresh=t,
                                                                        nms=False))

    def scale(head, factor):
        params[head]['conv1'].update({k: v * np.float32(factor)
                                      for k, v in params[head]['conv1'].items()})

    scale('fourier_head', 0.1)
    scale('location_head', 0.05)
    logits = np.asarray(runs[None](variables, x, 0.5)['dense_scores']).ravel()
    s = np.sort(logits)[::-1]
    i = 59 + int(np.argmax(s[59:199] - s[60:200]))
    # logit -> 50 (logit - mid) / std + 16.5: the cut between ranks i + 1 and
    # i + 2 lands on 16.5, and every pixel above it is saturated
    f = np.float32(50. / logits.std())
    head = params['score_head']['conv1']
    head['kernel'] = head['kernel'] * f
    head['bias'] = (head['bias'] - np.float32((s[i] + s[i + 1]) / 2)) * f + np.float32(16.5)
    thresh = float(1 / (1 + np.exp(-16.5)))
    pm.load_state_dict(state_dict_from_jax(variables), strict=True)
    out16 = pm.forward_padded(torch.from_numpy(x_np), score_thresh=thresh, nms=False)
    v16 = out16['valid'][0].numpy()
    assert abs(int(v16.sum()) - (i + 1)) <= 2
    kept = pm.forward_padded(torch.from_numpy(x_np), score_thresh=thresh)['valid'][0]
    assert 0 < int(kept.sum()) < int(v16.sum()) and not (kept.numpy() & ~v16).any()
    for run in runs.values():
        ref = {k: np.asarray(v)[0] for k, v in run(variables, x, thresh).items()
               if k in ('valid', 'boxes', 'scores', 'contours')}
        valid = ref['valid']
        s_ref, s16 = ref['scores'][valid], out16['scores'][0].numpy()[v16]
        assert abs(len(s_ref) - len(s16)) <= max(2, int(0.08 * len(s_ref))), (len(s_ref), len(s16))
        iou = np.asarray(box_iou(jnp.asarray(ref['boxes'][valid]),
                                 jnp.asarray(out16['boxes'][0].numpy()[v16])))
        j = iou.argmax(1)
        matched = iou[np.arange(len(s_ref)), j] > 0.8
        assert matched.mean() >= 0.92, matched.mean()
        np.testing.assert_allclose(s_ref[matched], s16[j[matched]], atol=2.5e-2)
        c_ref = ref['contours'][valid][matched]
        c16 = out16['contours'][0].numpy()[v16][j[matched]]
        assert np.abs(c_ref - c16).mean() < 0.5


class _FlaxNorm(flax.linen.Module):
    kind: str

    @flax.linen.compact
    def __call__(self, x):
        return jcommons.Norm(self.kind, name='n')(x)


@pytest.mark.parametrize('kind, channels', [('layernorm2d', 24), ('groupnorm', 64),
                                            ('groupnorm', 24), ('instancenorm2d', 24),
                                            ('LayerNormNd', 8)])
def test_norm_kinds_match_flax(kind, channels):
    rng = np.random.RandomState(channels)
    # a mean far from 0 against the spread: where one-pass and two-pass variances part most
    x = (3. + rng.randn(2, 9, 11, channels)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, channels).astype(np.float32)
    bias = (0.1 * rng.randn(channels)).astype(np.float32)
    fm = _FlaxNorm(kind)
    v = fm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {'params': {'n': {'norm': {'scale': jnp.asarray(scale), 'bias': jnp.asarray(bias)}}}}
    want = np.asarray(fm.apply(v, jnp.asarray(x)))
    norm = tcommons.Norm(channels, kind)
    assert not list(norm.buffers())
    norm.load_state_dict({'weight': torch.from_numpy(scale), 'bias': torch.from_numpy(bias)})
    got = norm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))
    if kind.startswith('group'):
        assert norm.num_groups == min(32, channels) and norm.eps == 1e-6
    # the kinds differ from one another on this input
    other = 'layernorm2d' if not kind.lower().startswith('layer') else 'instancenorm2d'
    alt = tcommons.Norm(channels, other)
    alt.load_state_dict(norm.state_dict())
    assert np.abs(alt(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
                  .detach().numpy() - want).max() > 1e-2
