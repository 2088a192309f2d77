"""Port parity: the Mamba token mixer, the secondary blocks, and the filter,
feature and pixel-norm layers; and bf16 of a ResNet-family CPN.

The same numpy-seeded inputs and weights (loaded through
``state_dict_from_jax`` with ``strict=True``) go through the JAX package and
the port with ``device='cpu'``, in fp32:

* ``selective_scan`` against JAX and a float64 sequential scan at
  ``B, L, D, N = 2, 17, 4, 8`` and at L = 1003: rtol 1e-4, atol 1e-5 (the
  gate of ``tests/test_models_extra.py``), with ``ceil(log2 L)`` rounds
  and no loop over the tokens; its backward against finite differences
  (``gradcheck`` in float64);
* ``Mamba``, ``MambaLayer`` (and its gradients against ``jax.grad``, within
  1e-4 of each tensor's peak), ``ResNetEncoder(secondary_block=MambaLayer,
  pyramid_pooling=True)`` in both stem layouts and ``GeneralizedUNet(
  secondary_block=MambaLayer)``: within 1e-5 of each output's peak
  (another order of summation: the scan's, the convolutions');
* a CPN slice through ``_slice_parity`` (CpnResNet18UNet at base 8 with
  the secondary block, 64^2 and 128^2), its weights both ways, and cdt
  files: the port loads the JAX package's (which the JAX package itself
  cannot rebuild), and writes one the JAX package reads the same way;
* ``PixelNorm`` (1e-6 relative), each filter and ``MultiscaleBasicFeatures``
  (1e-5 of the output's peak; the square root of the Hessian's
  discriminant, clipped at 0, amplifies rounding near 0 to 1e-3);
* bf16 compute of CpnResNet18UNet at base 8 (trained briefly, see the
  test) with the detection-level gates of ``test_cpn_u12_trained_bf16_matches_jax``.
"""
import functools
import json
import math

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from celldetection_tpu import models as jmodels
from celldetection_tpu.models import features as jfeatures
from celldetection_tpu.models import filters as jfilters
from celldetection_tpu.models import mamba as jmamba
from celldetection_tpu.models import normalization as jnorm
from celldetection_tpu.models import resnet as jresnet
from celldetection_tpu.models import unet as junet
from celldetection_tpu.ops.boxes import box_iou
from celldetection_tpu.util import serialization as jser
from celldetection_tpu_torch import models as tmodels
from celldetection_tpu_torch.models import features as tfeatures
from celldetection_tpu_torch.models import filters as tfilters
from celldetection_tpu_torch.models import mamba as tmamba
from celldetection_tpu_torch.models import resnet as tresnet
from celldetection_tpu_torch.models import unet as tunet
from celldetection_tpu_torch.util import serialization as tser
from celldetection_tpu_torch.util import (init_jax_variables, jax_variables_from_state_dict,
                                          state_dict_from_jax)
from test_torch_port_cpn import _numpy_tree, _slice_parity
from test_torch_port_cpn import one_torch_thread  # noqa: F401  (pytestmark)
from test_torch_port_resnet import _tame

pytestmark = pytest.mark.usefixtures('one_torch_thread')


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _perturbed(variables, seed, scale=0.1):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.randn(*np.shape(a)).astype(np.float32), variables)


def _load(module, variables, place=('backbone', 'body', 'm'), fused_initial=False):
    """JAX variables of a standalone module → the port ``module``, through
    ``state_dict_from_jax`` with the module placed at ``place`` in a CPN tree."""
    def nest(tree):
        for name in reversed(place):
            tree = {name: tree}
        return tree
    sd = state_dict_from_jax({c: nest(t) for c, t in _numpy_tree(variables).items()},
                             fused_initial=fused_initial)
    prefix = 'core.' + '.'.join(place) + '.'
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    return module.eval()


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(1., float(np.abs(want).max())))


@pytest.mark.parametrize('B, L, D, N', [(2, 17, 4, 8), (1, 1003, 3, 4)])
def test_selective_scan_matches_jax_and_sequential(B, L, D, N, monkeypatch):
    rng = np.random.RandomState(L)
    u = rng.randn(B, L, D).astype(np.float32)
    delta = (np.abs(rng.randn(B, L, D)) * 0.1 + 0.01).astype(np.float32)
    A = -(np.abs(rng.randn(D, N)) + 0.1).astype(np.float32)
    Bm, Cm = rng.randn(B, L, N).astype(np.float32), rng.randn(B, L, N).astype(np.float32)
    Dp = rng.randn(D).astype(np.float32)
    rounds = []
    addcmul = torch.addcmul
    monkeypatch.setattr(torch, 'addcmul', lambda *a, **k: rounds.append(1) or addcmul(*a, **k))
    got = tmamba.selective_scan(*map(torch.from_numpy, (u, delta, A, Bm, Cm, Dp))).numpy()
    assert len(rounds) == math.ceil(math.log2(L))          # log-depth, no loop over L
    want = np.asarray(jmamba.selective_scan(*map(jnp.asarray, (u, delta, A, Bm, Cm, Dp))))
    x, ys = np.zeros((B, D, N)), []
    for t in range(L):                                      # float64 sequential reference
        x = np.exp(delta[:, t, :, None].astype(float) * A) * x + \
            delta[:, t, :, None] * Bm[:, t, None, :] * u[:, t, :, None]
        ys.append(np.einsum('bn,bdn->bd', Cm[:, t], x))
    seq = np.stack(ys, 1) + u * Dp
    np.testing.assert_allclose(got, seq, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # under autograd: the same values, and a gradient
    t_args = [torch.from_numpy(a).requires_grad_() for a in (u, delta, A, Bm, Cm, Dp)]
    y = tmamba.selective_scan(*t_args)
    np.testing.assert_array_equal(y.detach().numpy(), got)
    y.square().sum().backward()
    assert all(torch.isfinite(a.grad).all() for a in t_args)


@pytest.mark.parametrize('L', [1, 2, 5, 16, 19])
def test_selective_scan_backward_gradcheck(L):
    """The scan's hand-written backward (the same scan from the end) against
    finite differences in float64 (``torch.autograd.gradcheck``'s defaults)."""
    g = torch.Generator().manual_seed(L)
    args = [torch.randn(2, L, 3, generator=g), torch.rand(2, L, 3, generator=g) * .3 + .01,
            -(torch.rand(3, 4, generator=g) + .1), torch.randn(2, L, 4, generator=g),
            torch.randn(2, L, 4, generator=g), torch.randn(3, generator=g)]
    assert torch.autograd.gradcheck(tmamba.selective_scan,
                                    [a.double().requires_grad_() for a in args])


def test_mamba_and_layer_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 23, 6).astype(np.float32)
    jm = jmamba.Mamba(d_state=8, d_conv=3, expand=2)
    v = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    pm = _load(tmamba.Mamba(6, d_state=8, d_conv=3, expand=2), v)
    with torch.no_grad():
        _close(pm(torch.from_numpy(x)).numpy(), jax.jit(jm.apply)(v, jnp.asarray(x)))
    img = rng.randn(2, 5, 7, 6).astype(np.float32) * 2 + 1
    jl = jmamba.MambaLayer()
    vl = _perturbed(jax.jit(jl.init)(jax.random.PRNGKey(1), jnp.asarray(img)), 2)
    pl = _load(tmamba.MambaLayer(6), vl)
    with torch.no_grad():
        _close(_nhwc(pl(_nchw(img))), jax.jit(jl.apply)(vl, jnp.asarray(img)))
    # and its gradients (the scan's backward) against jax.grad
    grads = jax.jit(jax.grad(lambda v: jnp.sum(jl.apply(v, jnp.asarray(img)) ** 2)))(vl)
    pl.zero_grad()
    pl(_nchw(img)).square().sum().backward()
    want = _load(tmamba.MambaLayer(6), grads)
    for name, p in pl.named_parameters():
        _close(p.grad.numpy(), want.state_dict()[name].numpy(), 1e-4)


@pytest.mark.parametrize('fused_initial', [True, False])
def test_resnet_encoder_secondary_block_and_ppm_match_jax(fused_initial):
    kw = dict(in_channels=1, layers=(1, 1, 1, 1), base_channel=8, pyramid_pooling=True,
              pyramid_pooling_channels=4, fused_initial=fused_initial)
    x = np.random.RandomState(3).rand(2, 32, 32, 1).astype(np.float32)
    enc_j = jresnet.ResNetEncoder(secondary_block=jmamba.MambaLayer, **kw)
    v = _perturbed(jax.jit(enc_j.init, static_argnums=2)(jax.random.PRNGKey(0), jnp.asarray(x),
                                                         False), 4, 0.05)
    assert 'secondary1' in v['params']
    enc_t = _load(tresnet.ResNetEncoder(secondary_block=tmamba.MambaLayer, **kw), v,
                  ('backbone', 'body'), fused_initial)
    fj = jax.jit(enc_j.apply, static_argnums=2)(v, jnp.asarray(x), False)
    with torch.no_grad():
        ft = enc_t(_nchw(x))
    assert list(ft) == list(fj) and ft[list(ft)[-1]].shape[1] == enc_t.out_channels[-1]
    for k in fj:
        _close(_nhwc(ft[k]), fj[k])


def test_unet_decoder_secondary_block_matches_jax():
    x = np.random.RandomState(5).rand(1, 16, 16, 1).astype(np.float32)
    enc_j = junet.UNetEncoder(in_channels=1, depth=3, base_channels=4)
    ve = jax.jit(enc_j.init, static_argnums=2)(jax.random.PRNGKey(0), jnp.asarray(x), False)
    feats = jax.jit(enc_j.apply, static_argnums=2)(ve, jnp.asarray(x), False)
    dec_j = junet.GeneralizedUNet(in_channels_list=enc_j.out_channels,
                                  in_strides_list=enc_j.out_strides,
                                  secondary_block=jmamba.MambaLayer)
    vd = _perturbed(jax.jit(dec_j.init, static_argnums=(2, 3))(jax.random.PRNGKey(1), feats,
                                                               (16, 16), False), 6)
    assert 'secondary0' in vd['params']
    dec_t = _load(tunet.GeneralizedUNet(enc_j.out_channels, in_strides_list=enc_j.out_strides,
                                        secondary_block=tmamba.MambaLayer), vd,
                  ('backbone', 'unet'))
    out_j = jax.jit(dec_j.apply, static_argnums=(2, 3))(vd, feats, (16, 16), False)
    with torch.no_grad():
        out_t = dec_t({k: _nchw(np.asarray(v)) for k, v in feats.items()}, size=(16, 16))
    assert sorted(out_t) == sorted(out_j)
    for k in out_j:
        _close(_nhwc(out_t[k]), out_j[k])


def _mamba_cpn(jax_side):
    ctor = (jmodels if jax_side else tmodels).CpnResNet18UNet
    layer = jmamba.MambaLayer if jax_side else tmamba.MambaLayer

    def build(backbone_kwargs=None, **kw):
        return ctor(backbone_kwargs=dict(backbone_kwargs or {}, secondary_block=layer), **kw)
    return build


def _tame_mamba(variables):
    """``_tame``, and each Mamba's output projection scaled by 0.01: its scan
    sums thousands of tokens, and random weights saturate the scores without."""
    _tame(variables)
    for name, block in variables['params']['backbone']['body'].items():
        if name.startswith('secondary'):
            block['mamba']['out_proj']['kernel'] *= np.float32(0.01)


@pytest.mark.parametrize('size, batch, seed', [(64, 2, 0), (128, 1, 1)])
def test_cpn_with_mamba_secondary_block_matches_jax(size, batch, seed):
    _slice_parity((_mamba_cpn(True), _mamba_cpn(False)), dict(base_channel=8), size=size,
                  batch=batch, capacity=size * size // 16, seed=seed, scale_weights=_tame_mamba)


def test_cpn_with_mamba_weights_and_files(tmp_path):
    bk = dict(base_channel=8)
    jm = _mamba_cpn(True)(in_channels=3, backbone_kwargs=bk)
    shapes = jax.eval_shape(lambda: jm.core.init({'params': jax.random.PRNGKey(0)},
                                                 jnp.zeros((1, 64, 64, 3)), False))
    rng = np.random.RandomState(0)
    variables = _numpy_tree(jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(s.dtype), shapes))
    pm = _mamba_cpn(False)(in_channels=3, backbone_kwargs=bk, device='cpu')
    sd = state_dict_from_jax(variables)
    assert 'core.backbone.body.secondary4.mamba.conv1d.weight' in sd
    assert sd['core.backbone.body.secondary1.mamba.conv1d.weight'].shape == (16, 1, 4)
    pm.load_state_dict(sd, strict=True)
    back = jax_variables_from_state_dict(pm.state_dict())
    assert jax.tree_util.tree_map(np.shape, back) == jax.tree_util.tree_map(np.shape, variables)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(back),
                                                    jax.tree_util.tree_leaves(variables)))
    again = init_jax_variables(pm, 1)
    assert jax.tree_util.tree_map(np.shape, again) == jax.tree_util.tree_map(np.shape, variables)

    # the JAX package writes such a file but cannot rebuild it (its class is a string there)
    jm.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    jfile, tfile = str(tmp_path / 'jax.cdt'), str(tmp_path / 'port.cdt')
    jser.save_model(jfile, jm)
    with pytest.raises(TypeError, match='not callable'):
        jser.load_model(jfile)
    loaded = tser.load_model(jfile, device='cpu')
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in sd.items())
    tser.save_model(tfile, loaded)
    for fn in (jfile, tfile):
        with open(fn, 'rb') as f:
            kwargs = json.loads(msgpack.unpackb(f.read(), strict_map_key=False)['cdt.models'])
        assert kwargs['kwargs']['backbone_kwargs']['secondary_block'].endswith(
            "models.mamba.MambaLayer'>")
    with pytest.raises(TypeError, match='not callable'):
        jser.load_model(tfile)
    again = tser.load_model(tfile, device='cpu')
    assert all(torch.equal(again.state_dict()[k], v) for k, v in sd.items())
    with pytest.raises(ValueError, match='secondary_block'):
        tser.build_cpn('CpnResNet18UNet', dict(in_channels=3, backbone_kwargs=dict(
            secondary_block='functools.partial(MambaLayer, d_state=8)')))


def test_pixel_norm_matches_jax():
    x = np.random.RandomState(7).randn(2, 5, 6, 7).astype(np.float32) * 3
    want = np.asarray(jnorm.PixelNorm().apply({}, jnp.asarray(x)))
    got = _nhwc(tmodels.PixelNorm()(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    from celldetection_tpu.ops.normalization import pixel_norm as jpn
    from celldetection_tpu_torch.ops import pixel_norm as tpn
    np.testing.assert_allclose(tpn(torch.from_numpy(x)).numpy(), np.asarray(jpn(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


FILTERS = [
    ('PascalFilter2d', dict(n=5), {}), ('ScharrFilter2d', dict(transpose=True), {}),
    ('SobelFilter2d', {}, {}), ('GaussianFilter2d', dict(size=7, sigma=1.3), {}),
    ('BoxFilter2d', dict(size=3), dict(stride=2)), ('LaplaceFilter2d', dict(diagonal=True), {}),
    ('SobelFilter2d', {}, dict(trainable=True, padding=0)),
    ('Filter2d', {}, dict(kernel=np.random.RandomState(0).randn(3, 3, 5), trainable=True)),
    ('Filter2d', {}, dict(kernel=np.random.RandomState(1).randn(2, 5, 3))),
]


@pytest.mark.parametrize('name, args, kwargs', FILTERS, ids=[f'{n}{i}' for i, (n, _, _) in
                                                             enumerate(FILTERS)])
def test_filter_matches_jax(name, args, kwargs):
    x = np.random.RandomState(8).rand(2, 17, 19, 3).astype(np.float32)
    fj = getattr(jfilters, name)(**args, **kwargs)
    v = fj.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ft = getattr(tfilters, name)(**args, **kwargs)
    if kwargs.get('trainable'):
        # flax names a Filter2d that its parent does not name ``Filter2d_0``;
        # its kernel keeps the JAX layout both ways
        v = _perturbed(v, 9)
        ft = _load(ft, v, place=('backbone', 'body', 'Filter2d_0'))
        np.testing.assert_array_equal(ft.weight.detach().numpy(), v['params']['kernel'])
        back = jax_variables_from_state_dict({'core.backbone.body.Filter2d_0.weight': ft.weight})
        np.testing.assert_array_equal(back['params']['backbone']['body']['Filter2d_0']['kernel'],
                                      v['params']['kernel'])
    else:
        assert not v and not ft.state_dict()
    with torch.no_grad():
        _close(_nhwc(ft(_nchw(x))), fj.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize('magnitude, method', [(True, 'scharr'), (False, 'sobel')])
def test_edge_and_up_filters_match_jax(magnitude, method):
    x = np.random.RandomState(10).rand(1, 12, 9, 2).astype(np.float32)
    fj = jfilters.EdgeFilter2d(magnitude=magnitude, method=method)
    with torch.no_grad():
        _close(_nhwc(tfilters.EdgeFilter2d(magnitude, method)(_nchw(x))),
               fj.apply({}, jnp.asarray(x)))
        up = jfilters.UpFilter2d(scale_factor=3 if magnitude else 2)
        _close(_nhwc(tfilters.UpFilter2d(scale_factor=3 if magnitude else 2)(_nchw(x))),
               up.apply({}, jnp.asarray(x)))
    np.testing.assert_array_equal(tfilters.pascal_kernel(4), jfilters.pascal_kernel(4))
    np.testing.assert_array_equal(tfilters.gaussian_kernel(5), jfilters.gaussian_kernel(5))


@pytest.mark.parametrize('kwargs', [{}, dict(sigmas=(0.7, 1.6), edges=False),
                                    dict(sigmas=(1.,), intensity=False, texture=True)])
def test_multiscale_basic_features_match_jax(kwargs):
    x = np.random.RandomState(11).rand(2, 24, 21, 2).astype(np.float32)
    want = np.asarray(jfeatures.MultiscaleBasicFeatures(**kwargs).apply({}, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(tfeatures.MultiscaleBasicFeatures(**kwargs)(_nchw(x)))
    assert got.shape == want.shape
    _close(got, want, 1e-3)                 # the clipped square root near 0 (see above)
    g = x.astype(np.float32)
    _close(_nhwc(tfeatures.texture_filter(_nchw(g))), jfeatures.texture_filter(jnp.asarray(g)),
           1e-5)


def test_cpn_resnet18_unet_bf16_matches_jax():
    """bf16 compute of CpnResNet18UNet at base 8 against the JAX package at
    fp32 and at bf16, with the gates of ``test_cpn_u12_trained_bf16_matches_jax``
    (see :func:`_bf16_parity`)."""
    _bf16_parity(None)


def test_cpn_resnet18_unet_mamba_bf16_matches_jax():
    """The same with a ``MambaLayer`` after each encoder stage: its
    parameters cast to bf16 as JAX's are, and the scan in bf16 over the
    first stage's 64^2 tokens, under the same gates."""
    _bf16_parity('mamba')


def _bf16_parity(secondary):
    """bf16 compute of CpnResNet18UNet at base 8 (with ``secondary`` =
    ``'mamba'``, a MambaLayer secondary block) against the JAX package at
    fp32 and at bf16, with the gates of ``test_cpn_u12_trained_bf16_matches_jax``
    (counts within 8%, 92% of the reference's boxes matched at IoU 0.8, their
    scores within 2.5e-2, their contours within 0.5 px on average), applied
    before NMS as ``test_convnext_v2_bf16_matches_jax`` does and for its
    reason (scores that are not peaked make NMS choose among near-equal
    neighbours). Trained-like weights: the port's own initialisation, trained
    for 12 steps on toy images (``init_jax_variables``' random norm statistics
    make a deep residual net chaotic, its bf16 logits off by a third of their
    spread); then the score head is shifted and scaled so that the widest gap
    of the fp32 logits between ranks 60 and 200 falls on logit 16.5, the
    threshold."""
    from celldetection_tpu_torch import data as tdata
    from celldetection_tpu_torch.runtime.trainer import CPNTrainer
    kw = dict(in_channels=3, max_detections=512, samples=32)

    def backbone(mamba):
        return dict(backbone_kwargs=dict(base_channel=8, **(
            {} if secondary is None else {'secondary_block': mamba.MambaLayer})))
    torch.manual_seed(0)
    trained = tmodels.CpnResNet18UNet(device='cpu', **kw, **backbone(tmamba))
    toy = [tdata.random_geometric_objects(128, 128, num=12, radius=(6, 14), seed=i)
           for i in range(8)]
    CPNTrainer(trained, optimizer={'Adam': {'lr': 2e-3}}, log_fn=lambda *a: None, seed=0).fit(
        [(np.repeat(im[..., None], 3, -1), lab) for im, lab in toy], epochs=6, batch_size=4,
        max_instances=32, samples=32, prefetch=0)
    variables = jax_variables_from_state_dict(trained.state_dict(), encoder='resnet')
    params = variables['params']
    img, _ = tdata.random_geometric_objects(256, 256, num=40, radius=(6, 14), seed=99)
    x_np = np.repeat(img[None, ..., None], 3, -1).astype(np.float32)
    x = jnp.asarray(x_np)
    runs = {}
    for dtype in (None, jnp.bfloat16):
        jm = jmodels.CpnResNet18UNet(compute_dtype=dtype, **kw, **backbone(jmamba))
        runs[dtype] = jax.jit(lambda v, x, t, jm=jm: jm.forward_padded(v, x, score_thresh=t,
                                                                        nms=False))
    logits = np.asarray(runs[None](variables, x, 0.5)['dense_scores']).ravel()
    s = np.sort(logits)[::-1]
    i = 59 + int(np.argmax(s[59:199] - s[60:200]))
    f = np.float32(50. / logits.std())
    head = params['score_head']['conv1']
    head['kernel'] = head['kernel'] * f
    head['bias'] = (head['bias'] - np.float32((s[i] + s[i + 1]) / 2)) * f + np.float32(16.5)
    thresh = float(1 / (1 + np.exp(-16.5)))
    pm = tmodels.CpnResNet18UNet(device='cpu', compute_dtype=torch.bfloat16, **kw,
                                 **backbone(tmamba))
    pm.load_state_dict(state_dict_from_jax(variables), strict=True)
    out16 = pm.forward_padded(torch.from_numpy(x_np), score_thresh=thresh, nms=False)
    v16 = out16['valid'][0].numpy()
    for run in runs.values():
        ref = {k: np.asarray(v)[0] for k, v in run(variables, x, thresh).items()
               if k in ('valid', 'boxes', 'scores', 'contours')}
        valid = ref['valid']
        s_ref, s16 = ref['scores'][valid], out16['scores'][0].numpy()[v16]
        assert len(s_ref) > 20
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
