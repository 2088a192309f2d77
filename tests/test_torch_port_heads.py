"""Port parity: the CPN head options (uncertainty head and its NMS, fused
multi-level head features, refinement buckets).

The same numpy-seeded weights and inputs go through the JAX package on the
CPU and through ``celldetection_tpu_torch`` with ``device='cpu'``, on CpnU22
at base 8 and 64^2 inputs, fp32:

* forwards through ``_slice_parity``'s gates (dense heads within 1e-4 of each
  map's peak, equal valid sets before and after NMS, contours within 1e-3 px
  on 99% of points) with the uncertainty head (``uncertainty_nms`` and a
  ``certainty_thresh`` placed in a wide gap of the mean uncertainties), two
  ``Fuse`` modules, three refinement buckets, and all of them together;
* ``cpn_decode`` on the same dense maps: the pixels ``certainty_thresh``
  masks, ``box_uncertainties``, and bucketed refinement, with the sampling
  of the default contour and of training targets;
* the uncertainty-weighted NMS keep set against JAX's ``batched_box_nms`` of
  ``scores * (1 - mean uncertainty)``;
* ``refinement_bucket_weight`` and ``resolve_refinement_buckets``;
* the weights both ways (``export_torch_state_dict`` keys), and cdt files
  with these options from the JAX package into the port and back;
* a training forward with ``uncertainty_head=True`` in float64 on both
  sides: the loss and each term, ``uncertainty`` among them, within 1e-10
  relative, and every gradient within 1e-9 of its tensor's largest (as
  ``tests/test_torch_port_train.py`` holds the gradients).
"""
import functools
import json

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from celldetection_tpu import models as jmodels
from celldetection_tpu.models import cpn as jcpn
from celldetection_tpu.ops import cpn as jops
from celldetection_tpu.util import serialization as jser
from celldetection_tpu.util.torch_import import export_torch_state_dict
from celldetection_tpu_torch import models as tmodels
from celldetection_tpu_torch.models import cpn as tcpn
from celldetection_tpu_torch.ops import cpn as tops
from celldetection_tpu_torch.util import serialization as tser
from celldetection_tpu_torch.util import init_jax_variables, jax_variables_from_state_dict, \
    state_dict_from_jax
from test_torch_port_cpn import _numpy_tree, _slice_parity, one_torch_thread  # noqa: F401
from test_torch_port_train import (_SharedDropout, _batch, _biases_before_norms, _float64,
                                   _jax_train_forward, _models)

pytestmark = pytest.mark.usefixtures('one_torch_thread')

SIZE, BATCH, BASE = 64, 2, 8
FUSE = dict(contour_features=('1', '2'), refinement_features=['0', '1'])
UNCERTAINTY = dict(uncertainty_head=True, uncertainty_nms=True)
OPTIONS = {'uncertainty': UNCERTAINTY, 'fuse': FUSE, 'buckets': dict(refinement_buckets=3),
           'all': dict(UNCERTAINTY, refinement_buckets=3, score_features=('1', '0'), **FUSE)}


def _certainty_in_gap(options, seed, capacity):
    """A ``certainty_thresh`` whose cut ``1 - t`` lies in the widest gap of
    the port's mean uncertainties between their 20th and 80th percentiles
    (the weights and input ``_slice_parity`` makes for ``seed``)."""
    pm = tmodels.CpnU22(in_channels=3, device='cpu', max_detections=capacity,
                        backbone_kwargs=dict(base_channels=BASE), **options)
    pm.load_state_dict(state_dict_from_jax(init_jax_variables(pm, seed)), strict=True)
    x = np.random.RandomState(seed).rand(BATCH, SIZE, SIZE, 3).astype(np.float32)
    with torch.no_grad():
        u = np.sort(pm.core(torch.from_numpy(x))['uncertainty'].mean(-1).numpy().ravel())
    lo, hi = int(0.2 * len(u)), int(0.8 * len(u))
    i = lo + int(np.argmax(u[lo + 1:hi] - u[lo:hi - 1]))
    assert u[i + 1] - u[i] > 1e-4
    return float(1 - (u[i] + u[i + 1]) / 2)


@pytest.mark.parametrize('case', sorted(OPTIONS))
def test_head_options_forward_matches_jax(case):
    options = dict(OPTIONS[case])
    seed, capacity = 4, 512
    if options.get('uncertainty_head'):
        options['certainty_thresh'] = _certainty_in_gap(options, seed, capacity)
    ctors = (functools.partial(jmodels.CpnU22, **options),
             functools.partial(tmodels.CpnU22, **options))
    _slice_parity(ctors, dict(base_channels=BASE), size=SIZE, batch=BATCH, capacity=capacity,
                  seed=seed)


def test_head_options_build_their_modules():
    pm = tmodels.CpnU22(in_channels=1, device='cpu', backbone_kwargs=dict(base_channels=BASE),
                        refinement_buckets=3, **UNCERTAINTY, **FUSE)
    core = pm.core
    assert isinstance(core.fourier_fuse, tmodels.Fuse) and isinstance(core.refinement_fuse,
                                                                      tmodels.Fuse)
    assert not hasattr(core, 'score_fuse') and not core.fusable
    assert core.refinement_head.block[4].out_channels == 6
    assert core.uncertainty_head.block[4].out_channels == 4
    # one level for every contour head: the uncertainty head joins the fused conv
    assert tmodels.CpnU22(in_channels=1, device='cpu', backbone_kwargs=dict(base_channels=BASE),
                          **UNCERTAINTY).core.fusable
    # a decoder level fused with an encoder level (``keep_features``' 'encoder.<k>' maps):
    # the same CPN as the JAX package's
    options = dict(contour_features=('1', 'encoder.0'))
    fuse = tmodels.CpnU22(in_channels=1, device='cpu', backbone_kwargs=dict(base_channels=BASE),
                          **options).core.fourier_fuse.block[0]
    assert (fuse.in_channels, fuse.out_channels) == (2 * BASE + BASE, 2 * BASE)
    _slice_parity((functools.partial(jmodels.CpnU22, **options),
                   functools.partial(tmodels.CpnU22, **options)), dict(base_channels=BASE),
                  size=SIZE, batch=BATCH, capacity=512, seed=5)


def _dense(rng, buckets, uncertainty=True):
    b, h, w, order = 2, 16, 16, 5
    dense = dict(scores=rng.randn(b, h, w, 1) * 2, locations=rng.randn(b, h, w, 2),
                 fourier=rng.randn(b, h, w, order * 4) * 2,
                 refinement=np.tanh(rng.randn(b, 2 * h, 2 * w, 2 * buckets)) * 3)
    if uncertainty:
        dense['uncertainty'] = rng.rand(b, h, w, 4)
    return {k: v.astype(np.float32) for k, v in dense.items()}


@pytest.mark.parametrize('buckets,training', [(1, False), (3, False), (4, True)])
def test_decode_certainty_uncertainties_and_buckets_match_jax(buckets, training):
    rng = np.random.RandomState(buckets)
    dense = _dense(rng, buckets)
    kw = dict(order=5, samples=12, score_channels=1, score_thresh=0.3, max_detections=300,
              refinement_iterations=3, refinement_buckets=buckets, certainty_thresh=0.45)
    sampling = np.sort(rng.rand(2, 12), -1).astype(np.float32) if training else None
    if sampling is not None:
        sampling[0, :3] = [0., 1 / 4, 0.5]    # bucket boundaries
    out_j = jcpn.cpn_decode({k: jnp.asarray(v) for k, v in dense.items()}, (32, 32),
                            sampling=None if sampling is None else jnp.asarray(sampling), **kw)
    out_p = tcpn.cpn_decode({k: torch.from_numpy(v) for k, v in dense.items()}, (32, 32),
                            sampling=None if sampling is None else torch.from_numpy(sampling),
                            **kw)
    certain = dense['uncertainty'].mean(-1) < 0.55
    scored = 1 / (1 + np.exp(-dense['scores'][..., 0])) > 0.3
    assert 0 < (scored & certain).sum() < (scored.sum())
    np.testing.assert_array_equal(out_p['fg_count'].numpy(), (scored & certain).sum((1, 2)))
    np.testing.assert_array_equal(out_p['fg_count'].numpy(), np.asarray(out_j['fg_count']))
    valid = out_p['valid'].numpy()
    np.testing.assert_array_equal(valid, np.asarray(out_j['valid']))
    np.testing.assert_array_equal(out_p['fg_index'].numpy()[valid],
                                  np.asarray(out_j['fg_index'])[valid])
    np.testing.assert_array_equal(out_p['box_uncertainties'].numpy()[valid],
                                  np.asarray(out_j['box_uncertainties'])[valid])
    diff = np.abs(out_p['contours'].numpy()[valid] - np.asarray(out_j['contours'])[valid])
    assert (diff <= 1e-3).all(-1).mean() >= 0.99 and diff.mean() < 0.1


def test_uncertainty_nms_keep_set_matches_jax():
    """The kept set of ``uncertainty_nms`` is JAX's ``batched_box_nms`` of the
    weighted scores, and differs from the kept set of the plain scores."""
    rng = np.random.RandomState(7)
    n = 400
    centers = rng.rand(2, n, 2) * 60
    sizes = rng.rand(2, n, 2) * 12 + 4
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], -1).astype(np.float32)
    scores = rng.rand(2, n).astype(np.float32)
    unc = rng.rand(2, n, 4).astype(np.float32)
    valid = rng.rand(2, n) > 0.1
    weights_j = jnp.asarray(scores) * (1. - jnp.asarray(unc).mean(-1))
    keep_j = np.asarray(jops.batched_box_nms(jnp.asarray(boxes), weights_j, jnp.asarray(valid),
                                             0.2))
    weights_p = torch.from_numpy(scores) * (1. - torch.from_numpy(unc).mean(-1))
    np.testing.assert_array_equal(weights_p.numpy(), np.asarray(weights_j))
    keep_p = tops.batched_box_nms(torch.from_numpy(boxes), weights_p, torch.from_numpy(valid),
                                  0.2).numpy()
    np.testing.assert_array_equal(keep_p, keep_j)
    plain = tops.batched_box_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                                 torch.from_numpy(valid), 0.2).numpy()
    assert (plain != keep_p).any()


@pytest.mark.parametrize('buckets', [1, 3, 8])
def test_refinement_buckets_match_jax(buckets):
    rng = np.random.RandomState(buckets)
    samplings = [np.linspace(0, 1, 33, dtype=np.float32),            # the default [S]
                 np.arange(buckets + 1, dtype=np.float32) / buckets,  # the bucket edges
                 rng.rand(2, 5, 12).astype(np.float32)]              # [B, K, S]
    for s in samplings:
        want = jops.resolve_refinement_buckets(jnp.asarray(s), buckets)
        got = tops.resolve_refinement_buckets(torch.from_numpy(s), buckets)
        assert len(got) == len(want) == 3
        for (gi, gw), (wi, ww) in zip(got, want):
            np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
            np.testing.assert_array_equal(gw.numpy(), np.asarray(ww))
    idx = rng.randint(-2, buckets + 2, 50).astype(np.float32)
    base = (rng.rand(50) * buckets).astype(np.float32)
    np.testing.assert_array_equal(
        tops.refinement_bucket_weight(torch.from_numpy(idx), torch.from_numpy(base)).numpy(),
        np.asarray(jops.refinement_bucket_weight(jnp.asarray(idx), jnp.asarray(base))))
    s = torch.rand(7, requires_grad=True)
    assert not any(w.requires_grad for _, w in tops.resolve_refinement_buckets(s, buckets))


ALL = dict(OPTIONS['all'], certainty_thresh=0.35)


def _jax_template(in_channels=1, **options):
    jm = jmodels.CpnU22(in_channels=in_channels, backbone_kwargs=dict(base_channels=BASE),
                        **options)
    shapes = jax.eval_shape(lambda: jm.core.init({'params': jax.random.PRNGKey(0)},
                                                 jnp.zeros((1, SIZE, SIZE, in_channels)), False))
    return jm, shapes


def test_weights_both_ways_with_head_options():
    _, shapes = _jax_template(**ALL)
    rng = np.random.RandomState(0)
    variables = _numpy_tree(jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(s.dtype), shapes))
    assert {'fourier_fuse', 'refinement_fuse', 'score_fuse', 'uncertainty_head'} <= \
        set(variables['params'])
    want = export_torch_state_dict(variables, encoder='unet')
    got = state_dict_from_jax(variables)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value), err_msg=key)
    pm = tmodels.CpnU22(in_channels=1, device='cpu', backbone_kwargs=dict(base_channels=BASE),
                        **ALL)
    pm.load_state_dict(got, strict=True)
    back = jax_variables_from_state_dict(pm.state_dict())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(variables)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(a, b)


def test_cdt_files_with_head_options_both_ways(tmp_path):
    pm = tmodels.CpnU22(in_channels=1, device='cpu', backbone_kwargs=dict(base_channels=BASE),
                        **ALL)
    variables = init_jax_variables(pm, 6)
    pm.load_state_dict(state_dict_from_jax(variables), strict=True)
    # the JAX package's file records uncertainty_head, the buckets and the
    # certainty threshold, not the features or uncertainty_nms: they are overrides
    jm, shapes = _jax_template(**ALL)
    jm.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    jfn = str(tmp_path / 'jax.cdt')
    jser.save_model(jfn, jm)
    with pytest.raises(RuntimeError, match='fuse'):
        tser.load_model(jfn, device='cpu')
    loaded = tser.load_model(jfn, device='cpu', uncertainty_nms=True, **FUSE,
                             score_features=('1', '0'))
    for k, v in pm.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[k], v, rtol=0, atol=0, msg=k)
    assert loaded.certainty_thresh == 0.35 and loaded.uncertainty_nms
    assert loaded.refinement_buckets == 3 and loaded.uncertainty_head
    # the port's file names every option: it loads as it is, in the port and in JAX
    pfn = str(tmp_path / 'port.cdt')
    tser.save_model(pfn, pm)
    again = tser.load_model(pfn, device='cpu')
    assert again.hparams == json.loads(json.dumps(pm.hparams))   # tuples read back as lists
    assert again.certainty_thresh == 0.35
    for k, v in pm.state_dict().items():
        torch.testing.assert_close(again.state_dict()[k], v, rtol=0, atol=0, msg=k)
    # the JAX package's dict2model restores the bytes into the template of the
    # model the file names (here from eval_shape: its init runs op by op)
    with open(pfn, 'rb') as f:
        raw = msgpack.unpackb(f.read(), strict_map_key=False)
    kwargs = json.loads(raw['cdt.models'])['kwargs']
    assert kwargs['contour_features'] == ['1', '2'] and kwargs['uncertainty_nms']
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    restored = _numpy_tree(serialization.from_bytes(template, raw['params_bytes']))
    for a, b in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(
            _numpy_tree(variables))):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope='module')
def uncertainty_train_pair():
    """A training forward with the uncertainty head on both sides, in float64
    (JAX with x64 for this fixture alone). In float32 the refinement term
    parts by 2e-5 relative here: the refinement rounds contour points to
    pixels, and float32 rounding moves some across a .5 boundary."""
    pm, jm, variables = _models(seed=5, uncertainty_head=True)
    x, targets = _batch(seed=12)
    x, targets, variables = x.astype(np.float64), _float64(targets), _float64(variables)
    dropout = _SharedDropout(9)
    with jax.enable_x64(True):
        jm.variables = jax.tree_util.tree_map(jnp.asarray, variables)
        j_loss, j_losses, j_grads, _ = _jax_train_forward(jm, variables, x, targets, dropout)
    dropout.hook_port(pm)
    pm.double().train()
    out = pm.forward_padded(torch.from_numpy(x),
                            targets={k: torch.from_numpy(v) for k, v in targets.items()},
                            generator=torch.Generator().manual_seed(0))
    out['loss'].backward()
    return dict(pm=pm, out=out, j_loss=j_loss, j_losses=j_losses, j_grads=j_grads)


def test_uncertainty_training_loss_matches_jax(uncertainty_train_pair):
    r = uncertainty_train_pair
    losses = r['out']['losses']
    assert set(losses) == set(r['j_losses']) and 'uncertainty' in losses
    assert r['j_losses']['uncertainty'] > 0
    np.testing.assert_allclose(r['out']['loss'].item(), r['j_loss'], rtol=1e-10)
    for k, v in r['j_losses'].items():
        np.testing.assert_allclose(losses[k].item(), v, rtol=1e-10, err_msg=k)


def test_uncertainty_training_gradients_match_jax(uncertainty_train_pair):
    r = uncertainty_train_pair
    want = state_dict_from_jax({'params': r['j_grads']})
    got = {k: p.grad for k, p in r['pm'].named_parameters()}
    assert sorted(got) == sorted(want) and any('uncertainty_head' in k for k in got)
    zero = _biases_before_norms(r['pm'])
    for key, g in got.items():
        assert g is not None and g.dtype == torch.float64 and torch.isfinite(g).all(), key
        scale_key = key[:-len('bias')] + 'weight' if key in zero else key
        atol = 1e-9 * float(np.abs(want[scale_key].numpy()).max())
        np.testing.assert_allclose(g.numpy(), want[key].numpy(), rtol=0, atol=atol, err_msg=key)
    assert float(r['pm'].core.uncertainty_head.block[4].weight.grad.abs().max()) > 0
