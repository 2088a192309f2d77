"""Port parity: the single-tile CPN slice (weights, dense heads, decode, NMS).

The same numpy-seeded weights and inputs go through the JAX package on the
CPU and through ``celldetection_tpu_torch`` with ``device='cpu'``:

* ``state_dict_from_jax`` against the JAX package's own
  ``export_torch_state_dict(encoder='unet')``: equal keys and values, and a
  ``strict=True`` load;
* fp32 ``CPN.forward_padded`` of a narrow CpnU22 at 128^2 and of the
  full-width CpnU22 at 64^2: dense heads within 1e-4 of each map's peak
  magnitude (fp32 convolutions summed in another order), equal valid sets before and after NMS, contours
  within 1e-3 px on at least 99% of points with a mean under 0.1 px (a
  refinement step that rounds a coordinate lying on a .5 boundary the other
  way moves a point by a whole pixel);
* bf16 compute on the trained fixture, with the detection-level gates of
  ``tests/test_bf16_parity.py``.

The score threshold is placed in a wide gap of the sorted scores, and the
capacity K is at least the foreground count, so that fp32 rounding cannot
move a pixel across the threshold or out of the top K.
"""
import json
import os

import jax
import jax.numpy as jnp
import flax
import msgpack
import numpy as np
import torch
from flax import serialization

from celldetection_tpu import models as jmodels
from celldetection_tpu.models import cpn as jcpn
from celldetection_tpu.ops.boxes import box_iou
from celldetection_tpu.util.torch_import import export_torch_state_dict
from celldetection_tpu_torch import models as tmodels
from celldetection_tpu_torch.util import init_jax_variables, state_dict_from_jax
from celldetection_tpu_torch.util.weights import body_layout

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'fixtures')


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in dict(tree).items()}


def test_state_dict_from_jax_matches_export_torch_state_dict():
    # the JAX package's own variable tree, filled with seeded random numbers
    jm = jmodels.CpnU22(in_channels=3, backbone_kwargs=dict(base_channels=4))
    shapes = jax.eval_shape(lambda: jm.core.init({'params': jax.random.PRNGKey(0)},
                                                 jnp.zeros((1, 64, 64, 3)), False))
    rng = np.random.RandomState(0)
    variables = _numpy_tree(jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(s.dtype), shapes))
    want = export_torch_state_dict(variables, encoder='unet')
    got = state_dict_from_jax(variables)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value), err_msg=key)
    pm = tmodels.CpnU22(in_channels=3, backbone_kwargs=dict(base_channels=4), device='cpu')
    assert sorted(pm.state_dict()) == sorted(want)
    pm.load_state_dict(got, strict=True)
    # and back: the port's seeded weights have the JAX package's variable tree
    again = init_jax_variables(pm, 1)
    assert jax.tree_util.tree_map(np.shape, again) == jax.tree_util.tree_map(np.shape, variables)


def threshold_in_gap(probs, lo, hi):
    """A threshold in the widest gap between the batch's sorted probabilities
    that leaves between ``lo`` and ``hi`` pixels of every image above it, and
    that gap."""
    per_image = np.sort(probs.reshape(probs.shape[0], -1), axis=1)
    s = np.sort(per_image.ravel())[::-1][:hi * len(per_image) + 1]
    mids, gaps = (s[:-1] + s[1:]) / 2, s[:-1] - s[1:]
    counts = np.stack([p.size - np.searchsorted(p, mids, side='right') for p in per_image])
    ok = ((counts >= lo) & (counts <= hi)).all(0)
    i = int(np.argmax(np.where(ok, gaps, -1.)))
    assert ok[i], 'no threshold leaves lo..hi pixels in every image'
    return float(mids[i]), float(gaps[i])


def _slice_parity(name, backbone_kwargs, size, batch, capacity, seed, classes=2,
                  scale_weights=None):
    """The port's CPN ``name`` against the JAX package's on the same weights:
    dense heads, valid sets before and after NMS, classes and contours.

    ``name`` is a zoo name, or a pair of constructors ``(jax_ctor,
    port_ctor)`` called with the keyword arguments of a zoo constructor
    (``device='cpu'`` for the port's). ``scale_weights`` edits the JAX
    variables in place before both load them (to keep a deep random
    network's scores off saturation). A ResNet body is compared in the
    layout of the port's model.
    """
    kw = dict(in_channels=3, max_detections=capacity, samples=32, classes=classes,
              backbone_kwargs=backbone_kwargs)
    jctor, pctor = (jmodels.get_cpn(name), tmodels.get_cpn(name)) if isinstance(name, str) \
        else name
    pm = pctor(device='cpu', **kw)
    variables = init_jax_variables(pm, seed)
    # shrink the score logits (random weights give 10-15 at full width, where
    # fp32 sigmoids saturate and leave no gap for a threshold)
    score_out = variables['params']['score_head']['conv1']
    score_out.update({k: v * np.float32(0.25) for k, v in score_out.items()})
    if scale_weights is not None:
        scale_weights(variables)
    _, fused = body_layout(pm)
    pm.load_state_dict(state_dict_from_jax(variables, fused_initial=fused), strict=True)
    jm = jctor(**kw)
    vj = jax.tree_util.tree_map(jnp.asarray, variables)
    x = np.random.RandomState(seed).rand(batch, size, size, 3).astype(np.float32)
    # one program gives the JAX package's detections and, caught on their way
    # through CPNCore, its dense heads; the score threshold is an argument, so
    # a second threshold reuses the compiled program
    def forward_j(v, x, t):
        dense = {}

        def catch_dense(call, args, kwargs, context):
            out = call(*args, **kwargs)
            if isinstance(context.module, jcpn.CPNCore) and context.method_name == '__call__':
                dense.update(out)
            return out

        with flax.linen.intercept_methods(catch_dense):
            out = jm.forward_padded(v, x, score_thresh=t, nms=True)
        return dense, out

    run_j = jax.jit(forward_j)

    dense_j, out_j = run_j(vj, jnp.asarray(x), jnp.float32(0.5))
    dense_j = {k: np.asarray(v) for k, v in dense_j.items() if v is not None}
    with torch.no_grad():
        dense_p = pm.core(torch.from_numpy(x))
    assert dense_p['uncertainty'] is None
    for key, ref in dense_j.items():   # 1e-4 of the map's peak, and at least 1e-4
        atol = 1e-4 * max(1., float(np.abs(ref).max()))
        np.testing.assert_allclose(dense_p[key].numpy(), ref, rtol=0, atol=atol, err_msg=key)

    if classes > 2:
        # classes are the argmax of the logits, the threshold plays no part:
        # the two largest logits of every pixel must lie far apart
        top2 = np.sort(dense_j['scores'], -1)[..., -2:]
        gap = float((top2[..., 1] - top2[..., 0]).min())
        err = float(np.abs(dense_p['scores'].numpy() - dense_j['scores']).max())
        assert gap > 10 * err, (gap, err)
        thresh = 0.5
    else:
        probs = 1 / (1 + np.exp(-dense_j['scores'].astype(np.float64)))
        thresh, gap = threshold_in_gap(probs, capacity // 8, capacity // 2)
        p_err = np.abs(torch.sigmoid(dense_p['scores']).numpy() - probs).max()
        assert gap > 10 * p_err, (gap, p_err)
        _, out_j = run_j(vj, jnp.asarray(x), jnp.float32(thresh))

    out_j = {k: np.asarray(out_j[k]) for k in ('valid', 'fg_index', 'fg_count', 'contours',
                                               'classes')}
    pre = pm.forward_padded(torch.from_numpy(x), score_thresh=thresh, nms=False)
    post = pm.forward_padded(torch.from_numpy(x), score_thresh=thresh)
    np.testing.assert_array_equal(post['fg_count'].numpy(), out_j['fg_count'])
    assert (out_j['fg_count'] <= capacity).all()

    n_pre = n_post = 0
    diffs = []
    for i in range(batch):
        idx_j, idx_p = out_j['fg_index'][i], pre['fg_index'][i].numpy()
        pre_valid = pre['valid'][i].numpy()
        # valid sets: before NMS all foreground pixels, after NMS the kept ones
        assert set(idx_p[pre_valid]) == set(idx_j[:out_j['fg_count'][i]])
        kept_p = set(idx_p[post['valid'][i].numpy()])
        assert kept_p == set(idx_j[out_j['valid'][i]])
        n_pre += int(pre_valid.sum())
        n_post += len(kept_p)
        slot_j = {p: s for s, p in enumerate(idx_j[:out_j['fg_count'][i]])}
        for s in np.nonzero(pre_valid)[0]:
            assert pre['classes'][i, s] == out_j['classes'][i, slot_j[idx_p[s]]]
            diffs.append(np.abs(pre['contours'][i, s].numpy() - out_j['contours'][i, slot_j[idx_p[s]]]))
    assert 0 < n_post < n_pre
    diffs = np.stack(diffs)
    assert (diffs <= 1e-3).all(-1).mean() >= 0.99
    assert diffs.mean() < 0.1


def test_cpn_u22_narrow_fp32_matches_jax():
    _slice_parity('CpnU22', dict(base_channels=8), size=128, batch=2, capacity=512, seed=0)


def test_cpn_u22_full_width_fp32_matches_jax():
    _slice_parity('CpnU22', None, size=64, batch=1, capacity=256, seed=1)


def test_cpn_u22_capacity_padding_matches_jax():
    """K above the score map's pixel count: the top-K pads invalid slots."""
    kw = dict(in_channels=3, max_detections=300, backbone_kwargs=dict(base_channels=4))
    pm = tmodels.CpnU22(device='cpu', **kw)
    variables = init_jax_variables(pm, 2)
    pm.load_state_dict(state_dict_from_jax(variables), strict=True)
    jm = jmodels.CpnU22(**kw)
    x = np.random.RandomState(2).rand(1, 32, 32, 3).astype(np.float32)   # 16 x 16 = 256 < K
    out_j = jax.jit(lambda v, x: jm.forward_padded(v, x, score_thresh=0., nms=False))(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x))
    out_p = pm.forward_padded(torch.from_numpy(x), score_thresh=0., nms=False)
    np.testing.assert_array_equal(out_p['valid'].numpy(), np.asarray(out_j['valid']))
    np.testing.assert_array_equal(out_p['fg_count'].numpy(), np.asarray(out_j['fg_count']))
    assert int(out_p['valid'].sum()) == 256
    res = pm(x, score_thresh=0.)
    assert res['fg_overflow'] == [False] and len(res['contours'][0]) <= 256


def test_forward_padded_offsets_and_capacity_match_jax():
    """Tile offsets added after the clamping and the boxes (global
    coordinates), and a per-call capacity (the capacity retry of tiled
    inference), against the JAX package's ``offsets=`` and a model of that
    capacity: equal valid sets and fg counts, every coordinate output within
    1e-3 px on 99% of values."""
    kw = dict(in_channels=3, samples=8, backbone_kwargs=dict(base_channels=4))
    pm = tmodels.CpnU22(device='cpu', max_detections=64, **kw)
    variables = init_jax_variables(pm, 3)
    pm.load_state_dict(state_dict_from_jax(variables), strict=True)
    jm = jmodels.CpnU22(max_detections=128, **kw)
    x = np.random.RandomState(3).rand(2, 64, 64, 3).astype(np.float32)
    offsets = np.float32([[48., 96.], [1024., 7680.]])
    out_j = jax.jit(lambda v, x, o: jm.forward_padded(v, x, score_thresh=0.5, nms=False,
                                                      offsets=o))(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x), jnp.asarray(offsets))
    out_p = pm.forward_padded(torch.from_numpy(x), score_thresh=0.5, nms=False,
                              offsets=torch.from_numpy(offsets), max_detections=128)
    np.testing.assert_array_equal(out_p['fg_count'].numpy(), np.asarray(out_j['fg_count']))
    valid = out_p['valid'].numpy()
    np.testing.assert_array_equal(valid, np.asarray(out_j['valid']))
    assert valid.shape == (2, 128) and 0 < valid.sum()
    for key in ('contours', 'contour_proposals', 'boxes', 'locations'):
        got, want = out_p[key].numpy()[valid], np.asarray(out_j[key])[valid]
        assert (np.abs(got - want) <= 1e-3).mean() >= 0.99, key
    assert (out_p['boxes'].numpy()[1][valid[1]][:, :2] >= offsets[1]).all()


def test_oversized_input_names_the_tiling_slice():
    """Above ``max_imsize`` the input goes through the tiling slice
    (``parallel/tiles.py``); its parity is ``tests/test_torch_port_tiles.py``."""
    pm = tmodels.CpnU22(in_channels=3, backbone_kwargs=dict(base_channels=4), max_imsize=32,
                        tile_size=32, tile_stride=24, device='cpu')
    out = pm(np.zeros((64, 64, 3), np.uint8))
    assert out['num_tiles'] == 9 and isinstance(out['fg_overflow'], bool)
    assert len(out['contours']) == 1 and out['contours'][0].shape[1:] == (32, 2)


def _trained_fixture():
    """The committed trained CpnU12: its JAX model (built by the JAX package
    from the file's stored config) and its variables as numpy arrays."""
    with open(os.path.join(FIXTURES, 'cpnu12_trained.cdt'), 'rb') as f:
        payload = msgpack.unpackb(f.read(), strict_map_key=False)
    kwargs = dict(json.loads(payload['cdt.models'])['kwargs'])
    name = kwargs.pop('model')
    in_channels = kwargs.pop('in_channels')
    backbone_kwargs = kwargs.pop('backbone_kwargs')
    kwargs.pop('uncertainty_head')
    variables = _numpy_tree(serialization.msgpack_restore(payload['params_bytes']))
    return name, in_channels, backbone_kwargs, kwargs, variables


def test_cpn_u12_trained_bf16_matches_jax():
    """bf16 compute on trained weights: the port against the JAX package at
    fp32 and at bf16, with the gates of ``tests/test_bf16_parity.py``."""
    from celldetection_tpu import data
    name, in_channels, backbone_kwargs, kwargs, variables = _trained_fixture()
    assert name == 'CpnU12'
    kwargs.pop('certainty_thresh', None)
    img, _ = data.random_geometric_objects(256, 256, num=48, radius=(6, 11), seed=99)
    img = img.astype(np.float32)[None, ..., None]

    pm = tmodels.CpnU12(in_channels, backbone_kwargs=backbone_kwargs,
                        compute_dtype=torch.bfloat16, device='cpu', **kwargs)
    pm.load_state_dict(state_dict_from_jax(variables), strict=True)
    out16 = pm(img, score_thresh=0.5)
    vj = jax.tree_util.tree_map(jnp.asarray, variables)
    for dtype in (None, jnp.bfloat16):
        jm = jmodels.get_cpn(name)(in_channels, backbone_kwargs=dict(backbone_kwargs),
                                   compute_dtype=dtype, **kwargs)
        out = jax.jit(lambda v, x: jm.forward_padded(v, x, score_thresh=0.5))(vj, jnp.asarray(img))
        ref = jm.detach(out)
        s_ref, s16 = ref['scores'][0], out16['scores'][0]
        assert len(s_ref) > 20, 'fixture fired on too few objects'
        assert abs(len(s_ref) - len(s16)) <= max(2, int(0.08 * len(s_ref))), (len(s_ref), len(s16))
        iou = np.asarray(box_iou(jnp.asarray(ref['boxes'][0]), jnp.asarray(out16['boxes'][0])))
        j = iou.argmax(1)
        matched = iou[np.arange(len(s_ref)), j] > 0.8
        assert matched.mean() >= 0.92, matched.mean()
        np.testing.assert_allclose(s_ref[matched], s16[j[matched]], atol=2.5e-2)
        c_ref = ref['contours'][0][matched]
        c16 = out16['contours'][0][j[matched]]
        assert np.abs(c_ref - c16).mean() < 0.5
