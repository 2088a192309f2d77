"""Port parity: the decode-chain ops and building blocks of ``celldetection_tpu_torch``.

Inputs are made with numpy from a seed and go through the JAX function (on
the CPU) and its port (``device='cpu'``); the committed reference fixtures
are checked too. Tolerances are fp32 rounding of the same arithmetic.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celldetection_tpu import ops as jops
from celldetection_tpu.models import commons as jcommons
from celldetection_tpu_torch import models as tmodels
from celldetection_tpu_torch import ops as tops
from celldetection_tpu_torch.util import resolve_device, state_dict_from_jax
from conftest import load_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(port, ref, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=rtol, atol=atol)


# -- ops/cpn.py ------------------------------------------------------------

@pytest.mark.parametrize('custom_sampling', [False, True])
def test_fouriers2contours_fixture(custom_sampling):
    fx = load_fixture('fouriers2contours.npz')
    if custom_sampling:
        con, _ = tops.fouriers2contours(t(fx['fourier']), t(fx['locations']),
                                        sampling=t(fx['sampling']))
        close(con, fx['contours_sampled'], atol=1e-4)
    else:
        con, samp = tops.fouriers2contours(t(fx['fourier']), t(fx['locations']), samples=32)
        close(con, fx['contours'], atol=1e-4)
        assert tuple(samp.shape) == (32,)


def test_fouriers2contours_matches_jax():
    rng = np.random.RandomState(0)
    fourier = (rng.randn(3, 50, 5, 4) * 10).astype(np.float32)
    loc = (rng.rand(3, 50, 2) * 100).astype(np.float32)
    ref, ref_s = jops.fouriers2contours(jnp.asarray(fourier), jnp.asarray(loc), samples=32)
    con, samp = tops.fouriers2contours(t(fourier), t(loc), samples=32)
    close(samp, ref_s, rtol=0, atol=0)
    close(con, ref, atol=2e-4)
    for args in ((5, 32), (3, 7), (2, 1)):
        for a, b in zip(tops.fourier_basis(*args), jops.fourier_basis(*args)):
            close(a, b, atol=1e-6)


@pytest.mark.parametrize('channels_last', [False, True])
def test_rel_location2abs_location(channels_last):
    fx = load_fixture('rel_location2abs_location.npz')
    loc, want = fx['locations'], fx['out']
    if channels_last:
        loc, want = np.moveaxis(loc, 1, -1), np.moveaxis(want, 1, -1)
    close(tops.rel_location2abs_location(t(loc)), want, rtol=1e-6, atol=1e-6)
    ref = jops.rel_location2abs_location(jnp.asarray(loc), channels_last=channels_last)
    close(tops.rel_location2abs_location(t(loc), channels_last=channels_last), ref, 0, 0)


def test_scale_contours_and_fourier():
    fx = load_fixture('scaling.npz')
    sc = tops.scale_contours((64, 48), (256, 192), t(fx['contours']))
    close(sc, fx['scaled_contours'], rtol=1e-6, atol=0)
    sf, sl = tops.scale_fourier((64, 48), (256, 192), t(fx['fourier']), t(fx['locations']))
    close(sf, fx['scaled_fourier'], rtol=1e-6, atol=0)
    close(sl, fx['scaled_locations'], rtol=1e-6, atol=0)
    rsf, rsl = jops.scale_fourier((64, 48), (256, 192), jnp.asarray(fx['fourier']),
                                  jnp.asarray(fx['locations']))
    close(sf, rsf, 0, 0)
    close(sl, rsl, 0, 0)
    close(tops.get_scale((64, 48), (256, 192)), jops.get_scale((64, 48), (256, 192)), 0, 0)
    close(tops.get_scale((64, 48), (256, 192), flip=False),
          jops.get_scale((64, 48), (256, 192), flip=False), 0, 0)


# -- ops/commons.py --------------------------------------------------------

def test_resize_bilinear_fixture_and_jax():
    fx = load_fixture('resize.npz')
    x = np.moveaxis(fx['x'], 1, -1)
    y = tops.resize_bilinear(t(x), (37, 41))
    close(y, np.moveaxis(fx['y'], 1, -1), rtol=1e-4, atol=1e-5)
    close(y, jops.resize_bilinear(jnp.asarray(x), (37, 41)), rtol=1e-5, atol=1e-5)
    assert torch.equal(tops.resize_bilinear(t(x), (16, 16)), t(x))   # equal size: no-op
    # a downscale antialiases, in JAX and in the port (the score bounds of
    # masked tiled inference): within fp32 rounding of the filter weights
    for size in ((8, 8), (5, 11)):
        close(tops.resize_bilinear(t(x), size), jops.resize_bilinear(jnp.asarray(x), size),
              rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('size', [(32, 48), (24, 20), (8, 8)])
def test_resize_nearest_matches_jax(size):
    x = np.random.RandomState(1).rand(2, 16, 12, 3).astype(np.float32)
    close(tops.resize_nearest(t(x), size), jops.resize_nearest(jnp.asarray(x), size), 0, 0)


@pytest.mark.parametrize('mode', ['bilinear', 'nearest'])
def test_equal_size_matches_jax(mode):
    rng = np.random.RandomState(2)
    x = rng.rand(1, 8, 8, 2).astype(np.float32)
    ref = rng.rand(1, 16, 24, 1).astype(np.float32)
    got = tops.equal_size(t(x), t(ref), mode)
    close(got, jops.equal_size(jnp.asarray(x), jnp.asarray(ref), mode), atol=1e-6)
    assert torch.equal(tops.equal_size(t(ref), t(ref)), t(ref))


@pytest.mark.parametrize('channels', [1, 2, 5])
def test_process_scores_matches_jax(channels):
    rng = np.random.RandomState(channels)
    logits = (rng.randn(2, 8, 8, channels) * 3).astype(np.float32)
    upper = rng.rand(2, 4, 4, 1 if channels <= 2 else channels).astype(np.float32)
    for kw in ({}, {'scores_upper_bound': upper}):
        s, c = tops.process_scores(t(logits), channels, 0.5,
                                   **{k: t(v) for k, v in kw.items()})
        rs, rc = jops.process_scores(jnp.asarray(logits), channels, 0.5,
                                     **{k: jnp.asarray(v) for k, v in kw.items()})
        close(s, rs, atol=1e-6)
        np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
        assert c.dtype == torch.int32


def test_box_area_matches_jax():
    b = np.random.RandomState(3).rand(5, 7, 4).astype(np.float32)
    close(tops.box_area(t(b)), jops.box_area(jnp.asarray(b)), 0, 0)


# -- models/commons.py -----------------------------------------------------

def _apply_flax(module, x, *args, seed=0):
    v = module.init(jax.random.PRNGKey(seed), jnp.asarray(x), *args)
    rng = np.random.RandomState(seed)
    # perturb the batch statistics so BatchNorm is no identity
    v = jax.tree_util.tree_map(np.array, v)   # writable copies
    for path, leaf in jax.tree_util.tree_flatten_with_path(v['batch_stats'])[0]:
        name = path[-1].key
        new = rng.uniform(0.5, 1.5, leaf.shape) if name == 'var' else 0.1 * rng.randn(*leaf.shape)
        leaf[...] = new.astype(np.float32)
    return v, np.asarray(module.apply(v, jnp.asarray(x), *args))


def _nchw(m, x):
    with torch.no_grad():
        return m(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def test_two_conv_norm_relu_matches_flax():
    x = np.random.RandomState(4).randn(2, 12, 10, 3).astype(np.float32)
    v, ref = _apply_flax(jcommons.TwoConvNormRelu(6), x, False)
    m = tmodels.TwoConvNormRelu(3, 6).eval()
    sd = state_dict_from_jax({c: {'backbone': {'body': {'block0': tree}}} for c, tree in v.items()})
    m.load_state_dict({k.replace('core.backbone.body.0.', ''): w for k, w in sd.items()},
                      strict=True)
    close(_nchw(m, x), ref, atol=2e-5)


def test_readout_and_fused_heads_match_flax():
    rng = np.random.RandomState(5)
    x = rng.randn(1, 9, 11, 4).astype(np.float32)
    heads, refs = [], []
    for i, out_c in enumerate((1, 2, 20)):
        v, ref = _apply_flax(jcommons.ReadOut(out_c, kernel_size=7, dropout=0.1), x, False,
                             seed=i)
        m = tmodels.FusableReadOut(4, out_c, kernel_size=7).eval()
        sd = state_dict_from_jax({c: {'score_head': tree} for c, tree in v.items()})
        m.load_state_dict({k.replace('core.score_head.', ''): w for k, w in sd.items()},
                          strict=True)
        close(_nchw(m, x), ref, atol=2e-5)
        heads.append(m)
        refs.append(ref)
    with torch.no_grad():   # one conv over the concatenated conv0s, then each head's tail
        mid = tmodels.fused_head_conv(t(x).permute(0, 3, 1, 2), [h.conv0 for h in heads], 1, 3)
        off = 0
        for h, ref in zip(heads, refs):
            c = h.conv0.out_channels
            close(h.tail(mid[:, off:off + c]).permute(0, 2, 3, 1), ref, atol=2e-5)
            off += c


def test_normalize_scaled_tanh_and_activations():
    x = np.random.RandomState(6).randn(2, 5, 5, 3).astype(np.float32)
    ref = jcommons.Normalize(mean=0.5, std=0.25).apply({}, jnp.asarray(x))
    close(_nchw(tmodels.Normalize(0.5, 0.25), x), ref, atol=1e-6)   # includes the [0, 1] clamp
    mean, std = (0.1, 0.2, 0.3), (0.5, 0.6, 0.7)
    ref = jcommons.Normalize(mean=mean, std=std).apply({}, jnp.asarray(x))
    close(_nchw(tmodels.Normalize(mean, std), x), ref, atol=1e-6)
    close(tmodels.ScaledTanh(3.)(t(x)), jcommons.ScaledTanh(3.).apply({}, jnp.asarray(x)),
          atol=1e-6)
    for name in ('relu', 'leaky_relu', 'gelu', 'silu', 'elu', 'tanh', 'sigmoid', None):
        ref = jcommons.get_activation(name)
        ref = np.asarray(ref(jnp.asarray(x))) if ref is not None else x
        close(tmodels.get_activation(name)(t(x)), ref, atol=1e-6)
    with pytest.raises(ValueError):
        tmodels.get_activation('no-such-activation')


# -- package rules ---------------------------------------------------------

def test_port_imports_no_jax():
    code = ('import sys, celldetection_tpu_torch, celldetection_tpu_torch.models, '
            'celldetection_tpu_torch.kernels.nms, celldetection_tpu_torch.util.weights\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "flax", "celldetection_tpu")]\n'
            'assert not bad, bad\n')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['PYTHONPATH'] = REPO
    subprocess.run([sys.executable, '-c', code], check=True, cwd=REPO, env=env, timeout=120)


def test_entry_points_default_to_cuda():
    assert resolve_device('cpu') == torch.device('cpu')
    if torch.cuda.is_available():
        assert resolve_device().type == 'cuda'
        return
    with pytest.raises(RuntimeError, match='no CUDA device'):
        resolve_device()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tmodels.CpnU22(in_channels=3, backbone_kwargs=dict(base_channels=4))
