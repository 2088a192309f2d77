"""Port parity: the rest of ``models/commons.py`` and CPN heads on encoder levels.

The same numpy-seeded weights and inputs go through the JAX package on the
CPU and through ``celldetection_tpu_torch`` with ``device='cpu'``, fp32:

* every block of the JAX ``commons.__all__`` that the port lacked
  (``SqueezeExcitation``, ``SelfAttention``, ``LayerNorm2d``,
  ``DynamicTanh``, ``AdditiveNoise``, ``BottleneckBlock``, ``GroupedConv``,
  ``TwoConvNormLeaky``, ``ScaledSigmoid``, ``MinibatchStdLayer``,
  ``SpatialSplit``, ``Stride``): the flax variables, filled from a seed,
  through ``state_dict_from_jax`` into the port's block (``strict=True``)
  and back through ``jax_variables_from_state_dict``; outputs within 1e-5
  relative (and 1e-5 of the output's peak, for values near 0).
  ``AdditiveNoise`` in eval mode and in train mode with the same noise on
  both sides (``jax.random.normal`` patched, the port's ``noise`` replaced);
* ``norm_overrides``: the running statistics and the output after a
  train-mode forward, and the eval-mode epsilon; ``kaiming_uniform``'s
  bound and fan-in; ``ReplayCache`` on one ``RandomState`` seed;
* every public name of the JAX ``models`` package imports from the port's;
  ``TimmMaNet``/``SmpMaNet`` resolve native encoders as the JAX package's do;
* CPN heads that read encoder levels (``'encoder.<k>'``), single and in a
  ``Fuse`` tuple, on CpnU22, CpnResNet18UNet and a narrow DenseNet UNet
  through ``_slice_parity``
  (dense heads within 1e-4 of each map's peak, equal valid sets before and
  after NMS, contours within 1e-3 px on 99% of points): the ``Fuse`` output
  of a tuple whose first key is an encoder level has decoder level k's
  channels, as the JAX CPN gives it; keys that name one tensor fuse the
  contour heads' convolutions as in the JAX package.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celldetection_tpu import models as jmodels
from celldetection_tpu.models import commons as jcommons
from celldetection_tpu_torch import models as tmodels
from celldetection_tpu_torch.models import commons as tcommons
from celldetection_tpu_torch.util import jax_variables_from_state_dict, state_dict_from_jax
from test_torch_port_cpn import _numpy_tree, _slice_parity
from test_torch_port_cpn import one_torch_thread  # noqa: F401  (pytestmark)
from test_torch_port_zoo import _densenet

pytestmark = pytest.mark.usefixtures('one_torch_thread')

NAMES = ['norm_overrides', 'kaiming_uniform', 'GroupedConv', 'TwoConvNormLeaky',
         'ScaledSigmoid', 'BottleneckBlock', 'SqueezeExcitation', 'SelfAttention', 'LayerNorm2d',
         'ReplayCache', 'MinibatchStdLayer', 'SpatialSplit', 'AdditiveNoise', 'Stride',
         'DynamicTanh']


def fill(shapes, seed):
    """Seeded values for a flax variable tree of ``jax.ShapeDtypeStruct``\\s:
    He-uniform kernels, scales and variances in [0.5, 1.5], ConvNeXt's layer
    scale in [0.05, 0.15], GRN's and attention's gamma/beta in [0.25, 0.75],
    everything else ``0.1 * N(0, 1)``."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == 'kernel':
            bound = np.sqrt(6.0 / int(np.prod(s.shape[:-1])))
            v = rng.uniform(-bound, bound, s.shape)
        elif name in ('scale', 'var'):
            v = rng.uniform(0.5, 1.5, s.shape)
        elif name == 'layer_scale':
            v = rng.uniform(0.05, 0.15, s.shape)
        elif name in ('gamma', 'beta'):
            v = rng.uniform(0.25, 0.75, s.shape)
        else:
            v = 0.1 * rng.randn(*s.shape)
        return v.astype(np.float32)

    return _numpy_tree(jax.tree_util.tree_map_with_path(leaf, shapes))


def flax_variables(module, *args, seed=0):
    """``module``'s flax variables for inputs ``args`` (numpy), seeded by :func:`fill`."""
    shapes = jax.eval_shape(lambda: module.init(
        {'params': jax.random.PRNGKey(0), 'noise': jax.random.PRNGKey(1)},
        *[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]))
    return fill(shapes, seed)


def nest(variables, path):
    """``{collection: tree}`` with each tree moved under ``path`` (a tuple of names)."""
    out = {}
    for coll, tree in variables.items():
        for name in reversed(path):
            tree = {name: tree}
        out[coll] = tree
    return out


def load_port(module, variables, path, prefix, fused_initial=False, encoder=None):
    """Load flax ``variables`` into the port's ``module`` through
    ``state_dict_from_jax`` (the JAX tree moved under ``path``, whose port
    keys start with ``prefix``), strictly, and check the way back
    (``jax_variables_from_state_dict``) gives the same tree."""
    wrapped = nest(variables, path)
    sd = state_dict_from_jax(wrapped, fused_initial)
    assert all(k.startswith(prefix) for k in sd), sorted(sd)
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    back = jax_variables_from_state_dict(sd, fused_initial, encoder)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(wrapped)
    for (p, a), b in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                         jax.tree_util.tree_leaves(wrapped)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(p))
    return module


def channels_last(t: torch.Tensor) -> np.ndarray:
    return t.detach().movedim(1, -1).numpy()


def close(port, ref, rtol=1e-5, peak_tol=1e-5):
    """``port`` (a numpy array) within ``rtol`` of ``ref``, and ``peak_tol`` of its peak."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=peak_tol * max(float(np.abs(ref).max()), 1e-30))


def run_both(jmod, tmod, x, path, prefix, *, train=False, seed=0, rtol=1e-5):
    """One block on channels-last ``x``: flax variables from ``seed`` into the
    port's block, both applied (the port to channels-first ``x``); returns
    the two outputs (channels-last numpy)."""
    variables = flax_variables(jmod, x, train, seed=seed)
    load_port(tmod, variables, path, prefix)
    ref = jmod.apply(variables, jnp.asarray(x), train)
    tmod.train(train)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).movedim(-1, 1))
    close(channels_last(got), ref, rtol=rtol)
    return got, ref


SECONDARY = (('backbone', 'unet', 'secondary0'), 'core.backbone.unet.secondary0.')


@pytest.mark.parametrize('kwargs', [{}, dict(squeeze_channels=3, residual=False),
                                    dict(compression=4, activation='gelu')])
def test_squeeze_excitation_matches_flax(kwargs):
    x = np.random.RandomState(1).randn(2, 9, 7, 32).astype(np.float32)
    run_both(jcommons.SqueezeExcitation(**kwargs), tcommons.SqueezeExcitation(32, **kwargs),
             x, *SECONDARY, seed=1)


@pytest.mark.parametrize('kwargs', [{}, dict(out_channels=24, mid_channels=6),
                                    dict(beta=False)])
def test_self_attention_matches_flax(kwargs):
    x = np.random.RandomState(2).randn(2, 8, 6, 16).astype(np.float32)
    jm = jcommons.SelfAttention(**kwargs)
    tm = tcommons.SelfAttention(16, **kwargs)
    run_both(jm, tm, x, *SECONDARY, seed=2)
    assert (tm.in_conv is None) == ('out_channels' not in kwargs)


def test_layer_norm_2d_and_dynamic_tanh_match_flax():
    x = (np.random.RandomState(3).randn(2, 5, 6, 12) * 3 + 1).astype(np.float32)
    tm = tcommons.LayerNorm2d(12)
    run_both(jcommons.LayerNorm2d(), tm, x, *SECONDARY, seed=3)
    assert sorted(tm.state_dict()) == ['ln.bias', 'ln.weight']
    tm = tcommons.DynamicTanh(12, alpha_init_value=0.3)
    run_both(jcommons.DynamicTanh(alpha_init_value=0.3), tm, x, *SECONDARY, seed=4)
    assert sorted(tm.state_dict()) == ['alpha', 'bias', 'weight']


@pytest.mark.parametrize('weighted', [True, False])
def test_additive_noise_matches_flax(weighted, monkeypatch):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 6, 5, 8).astype(np.float32)
    kw = dict(noise_channels=2, mean=0.3, std=1.5, weighted=weighted)
    jm, tm = jcommons.AdditiveNoise(**kw), tcommons.AdditiveNoise(8, **kw)
    variables = flax_variables(jm, x, True, seed=5)
    if weighted:
        load_port(tm, variables, *SECONDARY)
    else:
        assert not variables and not list(tm.state_dict())
    # eval mode: the identity on both sides
    np.testing.assert_array_equal(np.asarray(jm.apply(variables, jnp.asarray(x), False)), x)
    tm.eval()
    np.testing.assert_array_equal(channels_last(tm(torch.from_numpy(x).movedim(-1, 1))), x)
    # train mode: the same standard normal draws injected on both sides
    noise = rng.randn(2, 6, 5, 2).astype(np.float32)
    monkeypatch.setattr(jax.random, 'normal', lambda key, shape: jnp.asarray(noise))
    ref = jm.apply(variables, jnp.asarray(x), True, rngs={'noise': jax.random.PRNGKey(0)})
    tm.train()
    tm.noise = lambda t: torch.from_numpy(noise).movedim(-1, 1)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).movedim(-1, 1))
    close(channels_last(got), ref)
    assert not np.array_equal(np.asarray(ref), x)
    # the port's own draws come from its generator, on the input's device
    tm = tcommons.AdditiveNoise(8, generator=torch.Generator().manual_seed(0)).train()
    assert tm.noise(torch.zeros(2, 8, 3, 3)).shape == (2, 1, 3, 3)


@pytest.mark.parametrize('nd, kwargs', [(2, {}), (2, dict(stride=2, groups=2, mid_channels=12)),
                                        (3, dict(compression=2, base_channels=4))])
def test_bottleneck_block_matches_flax(nd, kwargs):
    x = np.random.RandomState(6).randn(2, *(6,) * nd, 8).astype(np.float32)
    jkw = {('feature_group_count' if k == 'groups' else k): v for k, v in kwargs.items()}
    tm = tcommons.BottleneckBlock(8, 16, nd=nd, **kwargs)
    # a U-Net encoder's block1 (body.1 = Sequential(pool, block))
    run_both(jcommons.BottleneckBlock(16, **jkw), tm, x, ('backbone', 'body', 'block1'),
             'core.backbone.body.1.1.', seed=6)
    assert {k.split('.')[0] for k in tm.state_dict()} == {'block0', 'block1', 'block2',
                                                          'downsample'}


def test_bottleneck_unet_matches_flax():
    """``block_cls=BottleneckBlock`` in the U-Net encoder and decoder, the whole backbone."""
    x = np.random.RandomState(7).rand(1, 32, 32, 1).astype(np.float32)
    jm = jmodels.unet._make_encoder_unet(1, 2, 8, 3, block_cls=jcommons.BottleneckBlock)
    tm = tmodels.unet._make_encoder_unet(1, 2, 8, 3, block_cls=tcommons.BottleneckBlock)
    run_both(jm, tm, x, ('backbone',), 'core.backbone.', seed=7, rtol=1e-4)


@pytest.mark.parametrize('nd, c, groups, batch, strides, padding', [
    (2, 32, 4, 1, None, 1),            # 8 channels a group: the JAX package's dense form
    (2, 64, 2, 2, (2, 2), [(1, 1), (1, 1)]),   # 32 a group at batch 2: native
    (3, 16, 4, 1, None, 0),
])
def test_grouped_conv_matches_flax(nd, c, groups, batch, strides, padding):
    x = np.random.RandomState(8).randn(batch, *(7,) * nd, c).astype(np.float32)
    k = (3,) * nd
    jm = jcommons.GroupedConv(24, k, groups, strides=strides, padding=padding)
    variables = flax_variables(jm, x, seed=8)
    tm = load_port(tcommons.GroupedConv(c, 24, k, groups, strides=strides, padding=padding),
                   variables, ('backbone', 'body', 'gconv'), 'core.backbone.body.gconv.')
    with torch.no_grad():
        got = tm(torch.from_numpy(x).movedim(-1, 1))
    close(channels_last(got), jm.apply(variables, jnp.asarray(x)))


def test_parameter_free_blocks_match_jax():
    rng = np.random.RandomState(9)
    x = rng.randn(4, 8, 6, 6).astype(np.float32)
    xt = torch.from_numpy(x).movedim(-1, 1)
    for jm, tm in ((jcommons.MinibatchStdLayer(), tcommons.MinibatchStdLayer()),
                   (jcommons.MinibatchStdLayer(2, 2), tcommons.MinibatchStdLayer(2, 2)),
                   (jcommons.SpatialSplit(4, 3), tcommons.SpatialSplit(4, 3)),
                   (jcommons.Stride(2, 1), tcommons.Stride(2, 1)),
                   (jcommons.ScaledSigmoid(3., -1.), tcommons.ScaledSigmoid(3., -1.))):
        close(channels_last(tm(xt)), jm.apply({}, jnp.asarray(x)), rtol=1e-6)
    x3 = rng.randn(2, 5, 6, 7, 3).astype(np.float32)
    close(channels_last(tcommons.Stride(3)(torch.from_numpy(x3).movedim(-1, 1))),
          jcommons.Stride(3).apply({}, jnp.asarray(x3)), rtol=0)


def test_two_conv_norm_leaky_matches_flax():
    x = np.random.RandomState(10).randn(2, 9, 8, 3).astype(np.float32)
    tm = tcommons.TwoConvNormLeaky(3, 6)
    assert isinstance(tm[2], torch.nn.LeakyReLU)
    run_both(jcommons.TwoConvNormLeaky(6), tm, x, ('backbone', 'body', 'block0'),
             'core.backbone.body.0.', seed=10)


@pytest.mark.parametrize('train', [False, True])
def test_norm_overrides_match_flax(train):
    """Inside ``norm_overrides`` the batch norms take its momentum and epsilon:
    the output and, in train mode, the running statistics after one forward."""
    x = (np.random.RandomState(11).randn(3, 7, 6, 3) * 2 + 0.5).astype(np.float32)
    overrides = {'batchnorm': {'momentum': 0.6, 'epsilon': 0.5}}
    jm, tm = jcommons.TwoConvNormRelu(6), tcommons.TwoConvNormRelu(3, 6)
    variables = flax_variables(jm, x, False, seed=11)
    load_port(tm, variables, ('backbone', 'body', 'block0'), 'core.backbone.body.0.')
    tm.train(train)
    with jcommons.norm_overrides(overrides):
        ref, updates = jm.apply(variables, jnp.asarray(x), train, mutable=['batch_stats'])
    with tcommons.norm_overrides(overrides):
        with torch.no_grad():
            got = tm(torch.from_numpy(x).movedim(-1, 1))
    close(channels_last(got), ref, rtol=1e-4, peak_tol=1e-5)
    stats = updates['batch_stats'] if train else variables['batch_stats']
    for block, norm in (('block0', tm[1]), ('block1', tm[4])):
        close(norm.running_mean.numpy(), stats[block]['norm']['norm']['mean'])
        close(norm.running_var.numpy(), stats[block]['norm']['norm']['var'])
    # outside the block: the norms' own settings again, which the outputs tell apart
    with torch.no_grad():
        plain = tm(torch.from_numpy(x).movedim(-1, 1))
    assert not np.allclose(channels_last(plain), np.asarray(ref), atol=1e-3)
    assert tcommons._current_norm_overrides() == {}


def test_kaiming_uniform_bound_matches_jax():
    a = 0.5
    jinit = jcommons.kaiming_uniform(a)
    tinit = tcommons.kaiming_uniform(a)
    ref = np.asarray(jinit(jax.random.PRNGKey(0), (3, 3, 40, 64)))      # HWIO, fan-in 360
    got = tinit(torch.empty(64, 40, 3, 3), torch.Generator().manual_seed(0))
    bound = np.sqrt(2 / (1 + a ** 2)) * np.sqrt(3 / 360)
    for v in (ref, got.numpy()):
        assert np.abs(v).max() <= bound and np.abs(v).max() > 0.99 * bound
        np.testing.assert_allclose(v.std(), bound / np.sqrt(3), rtol=0.02)
    assert tinit(torch.empty(7)).abs().max() <= np.sqrt(2 / 1.25) * np.sqrt(3)   # fan-in 1


def test_replay_cache_matches_jax():
    jc = jcommons.ReplayCache(size=5, rng=np.random.RandomState(12))
    tc = tcommons.ReplayCache(size=5, rng=np.random.RandomState(12))
    assert tc(3, device='cpu') is None and tc.is_empty()
    data = np.random.RandomState(13).rand(6, 4, 2, 2).astype(np.float32)
    for batch in (data[:4], data[2:], data):
        jc.add(batch, fraction=0.75)
        tc.add(torch.from_numpy(batch), fraction=0.75)
        assert len(tc) == len(jc) <= 5
        got = tc(7, device='cpu')
        assert isinstance(got, torch.Tensor) and got.device.type == 'cpu'
        np.testing.assert_array_equal(got.numpy(), np.asarray(jc(7)))
    if not torch.cuda.is_available():     # the card unless the caller names another device
        with pytest.raises(RuntimeError, match='no CUDA device'):
            tc(1)


def test_models_export_every_jax_name():
    public = {n for n in dir(jmodels) if not n.startswith('_')}
    missing = sorted(n for n in public if not hasattr(tmodels, n))
    assert not missing, missing
    assert set(NAMES) <= set(tmodels.__all__) and set(NAMES) <= set(tcommons.__all__)
    assert set(NAMES) <= set(jcommons.__all__)



def test_timm_and_smp_manet_resolve_native_encoders():
    """``TimmMaNet``/``SmpMaNet``: the native encoder for a name of the native
    table, as the JAX package resolves it; another name needs timm or smp."""
    for jctor, tctor in ((jmodels.TimmMaNet, tmodels.TimmMaNet),
                         (jmodels.SmpMaNet, tmodels.SmpMaNet)):
        tm = tctor('resnet18', 1, backbone_kwargs=dict(base_channel=8))
        jm = jctor('resnet18', 1, backbone_kwargs=dict(base_channel=8))
        assert isinstance(tm.body, tmodels.ResNetEncoder)
        assert tm.feature_channels == jm.feature_channels == [8, 16, 32, 64]
        with pytest.raises((ImportError, KeyError, ValueError, RuntimeError)):
            tctor('nosuch_net_xyz', 1)


# -- CPN heads on encoder levels ---------------------------------------------

ENCODER_CASES = {
    # a single encoder key, and a decoder level fused with the encoder level of its stride
    'single': dict(score_features='encoder.1'),
    'fuse': dict(contour_features=('1', 'encoder.1'), refinement_features=('0', 'encoder.0')),
    'both': dict(score_features='encoder.1', contour_features=('encoder.1', '1'),
                 location_features='encoder.1', refinement_features='encoder.0'),
}


@pytest.mark.parametrize('case', sorted(ENCODER_CASES))
def test_cpn_u22_encoder_level_heads_match_jax(case):
    options = ENCODER_CASES[case]
    ctors = (functools.partial(jmodels.CpnU22, **options),
             functools.partial(tmodels.CpnU22, **options))
    _slice_parity(ctors, dict(base_channels=8), size=64, batch=2, capacity=512, seed=13)


def test_cpn_u22_keys_of_one_tensor_fuse_as_in_jax():
    """The U-Net's deepest decoder level is its deepest encoder map: the JAX
    package fuses heads that read '4' and 'encoder.4' into one conv, and so
    does the port."""
    options = dict(score_features='encoder.4', location_features='4', contour_features='4',
                   refinement_features='encoder.0')
    pm = tmodels.CpnU22(1, device='cpu', backbone_kwargs=dict(base_channels=4), **options)
    assert not pm.core.fusable
    with torch.no_grad():
        feats = pm.core.backbone(torch.zeros(1, 1, 64, 64))
    assert pm.core._one_map(feats)
    ctors = (functools.partial(jmodels.CpnU22, **options),
             functools.partial(tmodels.CpnU22, **options))
    _slice_parity(ctors, dict(base_channels=8), size=128, batch=1, capacity=64, seed=14)


def _tame(variables):
    """The last norm of each ResNet branch and the refinement output scaled
    down (random residual nets saturate the score sigmoid and ``3 tanh``)."""
    params = variables['params']
    for layer, blocks in params['backbone']['body'].items():
        if layer.startswith('layer'):
            for block in blocks.values():
                last = block['bn3' if 'bn3' in block else 'bn2']['norm']
                last.update({k: v * np.float32(0.1) for k, v in last.items()})
    out = params['refinement_head']['conv1']
    out.update({k: v * np.float32(0.01) for k, v in out.items()})


def test_cpn_resnet_encoder_level_heads_match_jax():
    """With stride bridging the encoder keys name the encoder's own levels:
    'encoder.2' is stride 8, decoder level '2' stride 4 (both 16 channels
    at base 8). A ``Fuse`` whose first key is 'encoder.2' resizes to that
    map; the other heads read maps of its stride, 'encoder.2' and decoder
    level '3'."""
    options = dict(contour_features=('encoder.2', '2'), score_features='encoder.2',
                   location_features='3')
    pm = tmodels.CpnResNet18UNet(3, device='cpu', backbone_kwargs=dict(base_channel=8),
                                 **options)
    fuse = pm.core.fourier_fuse.block[0]
    assert (fuse.in_channels, fuse.out_channels) == (16 + 16, 16)
    ctors = (functools.partial(jmodels.CpnResNet18UNet, **options),
             functools.partial(tmodels.CpnResNet18UNet, **options))
    _slice_parity(ctors, dict(base_channel=8), size=128, batch=1, capacity=256, seed=15,
                  scale_weights=_tame)


def test_cpn_encoder_key_first_in_fuse_keeps_jax_channels():
    """The parity trap: for a tuple of keys the JAX CPN passes no encoder
    channels, so a first key 'encoder.<k>' gives the ``Fuse`` decoder level
    k's channels. A narrow DenseNet UNet's 'encoder.1' has 40 channels at
    stride 8, decoder level '1' 32 at stride 2: the ``Fuse`` of
    ('encoder.1', '3') takes 40 + 36 channels at stride 8 and gives 32."""
    jctor, pctor = _densenet()
    options = dict(contour_features=('encoder.1', '3'), score_features='encoder.1',
                   location_features='3')
    pm = pctor(3, device='cpu', **options)
    fuse = pm.core.fourier_fuse.block[0]
    assert (fuse.in_channels, fuse.out_channels) == (40 + 36, 32)
    assert pm.core.score_head.conv0.in_channels == 40
    ctors = (functools.partial(jctor, **options), functools.partial(pctor, **options))
    _slice_parity(ctors, None, size=128, batch=1, capacity=256, seed=16, scale_weights=_tame)
