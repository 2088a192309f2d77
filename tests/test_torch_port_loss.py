"""Port parity: ``ops/loss.py``, values and gradients.

Every loss of the port against the JAX package's on the same numpy-seeded
inputs: the value within 1e-6 relative (1e-7 absolute) and the gradient
(``torch.autograd`` against ``jax.grad``) within 1e-5 of its largest
magnitude, including NaN at the same places. The cases cover empty masks,
boxes under ``min_size``, masked slots whose values make ``log`` or a
division blow up (their gradients are NaN in both frameworks, or finite in
both), values exactly at the ties of ``clip`` and ``abs``, and every
reduction.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celldetection_tpu.ops import loss as jl
from celldetection_tpu_torch.ops import loss as tl


def _run(name, arrays, argnums=(0,), **kw):
    """The loss ``name`` of both packages on ``arrays``: values, and the
    gradients of the summed output w.r.t. ``argnums``."""
    fn_j, fn_t = getattr(jl, name), getattr(tl, name)
    kw_j = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    kw_t = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    want = np.asarray(fn_j(*[jnp.asarray(a) for a in arrays], **kw_j))
    grads_j = jax.grad(lambda *a: jnp.sum(fn_j(*a, **kw_j)), argnums=argnums)(
        *[jnp.asarray(a) for a in arrays])
    ts = [torch.tensor(a, requires_grad=i in argnums) for i, a in enumerate(arrays)]
    out = fn_t(*ts, **kw_t)
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-6, atol=1e-7)
    for i, gj in zip(argnums, grads_j):
        gt, gj = ts[i].grad.numpy(), np.asarray(gj)
        np.testing.assert_array_equal(np.isnan(gt), np.isnan(gj))
        finite = ~np.isnan(gj)
        scale = max(float(np.abs(gj[finite]).max()) if finite.any() else 0., 1e-12)
        np.testing.assert_allclose(gt[finite], gj[finite], rtol=0, atol=1e-5 * scale)


RNG = np.random.RandomState(0)
X = (RNG.randn(6, 5) * 3).astype(np.float32)
X[0, :3] = 0.                                  # ties of clip(x, 0) and |x|
T01 = (RNG.rand(6, 5) > .5).astype(np.float32)
MASKS = {'none': None, 'rows': RNG.rand(6) > .4, 'elements': RNG.rand(6, 5) > .5,
         'empty': np.zeros(6, bool)}


# reduction 'none' ignores the mask, so it runs once, without one
REDUCTIONS = [(r, m) for r in ('mean', 'sum') for m in MASKS] + [('none', 'none')]


@pytest.mark.parametrize('reduction,mask', REDUCTIONS)
@pytest.mark.parametrize('name', ['l1_loss', 'bce_with_logits', 'sigmoid_focal_loss'])
def test_elementwise_losses(name, reduction, mask):
    kw = dict(reduction=reduction, mask=MASKS[mask])
    if name == 'l1_loss':
        _run(name, [X, np.round(X)], argnums=(0, 1), **kw)
    else:
        _run(name, [X, T01], argnums=(0,), **kw)


@pytest.mark.parametrize('mask', ['none', 'rows', 'empty'])
def test_cross_entropy(mask):
    logits = (RNG.randn(6, 4, 3) * 2).astype(np.float32)
    targets = RNG.randint(0, 3, (6, 4)).astype(np.int32)
    _run('cross_entropy', [logits, targets], mask=MASKS[mask])


@pytest.mark.parametrize('name', ['margin_loss', 'log_margin_loss'])
def test_margin_losses(name):
    p = RNG.rand(6, 5).astype(np.float32)
    p[0, 0], p[1, 1] = 0.9, 0.1            # at the margins (relu's kink)
    for kw in (dict(), dict(m_pos=.8, m_neg=.3, exponent=2, mask=MASKS['rows'])):
        _run(name, [p, T01], **kw)


def _boxes(n, rng, degenerate=0):
    xy = rng.rand(n, 2).astype(np.float32) * 20
    wh = rng.rand(n, 2).astype(np.float32) * 10 + .5
    wh[:degenerate] = rng.rand(degenerate, 2) * .9          # under min_size 1
    return np.concatenate([xy, xy + wh], -1)


@pytest.mark.parametrize('generalized', [True, False])
@pytest.mark.parametrize('method', ['linear', 'log'])
@pytest.mark.parametrize('mask', ['none', 'rows', 'empty'])
def test_iou_loss(generalized, method, mask):
    rng = np.random.RandomState(3)
    a, b = _boxes(6, rng, degenerate=2), _boxes(6, rng)
    b[3] = a[3] + 40                       # no overlap: IoU 0
    b[4] = a[4]                            # identical boxes: ties of min and max
    _run('iou_loss', [a, b], argnums=(0, 1), generalized=generalized, method=method,
         min_size=1., mask=MASKS[mask])


def test_iou_loss_masked_slots_with_nan_gradients():
    """Invalid slots gather index 0 and may hold boxes of zero area: their
    log and division give NaN or inf gradients, in the port exactly as in JAX."""
    rng = np.random.RandomState(4)
    a, b = _boxes(6, rng), _boxes(6, rng)
    a[4:] = 0.                             # zero-area boxes in the masked slots
    b[4:] = 0.
    mask = np.array([1, 1, 1, 1, 0, 0], bool)
    for generalized in (True, False):
        _run('iou_loss', [a, b], argnums=(0, 1), generalized=generalized, method='log',
             mask=mask, eps=0.)


@pytest.mark.parametrize('sigmoid', [False, True])
@pytest.mark.parametrize('mask', ['none', 'rows', 'empty'])
def test_box_npll_loss(sigmoid, mask):
    rng = np.random.RandomState(5)
    a, b = _boxes(6, rng, degenerate=1), _boxes(6, rng)
    u = rng.rand(6, 4).astype(np.float32)
    u[5] = 0.                              # delta 0: log(eps) and a / eps
    _run('box_npll_loss', [u, a, b], argnums=(0, 1), sigmoid=sigmoid, min_size=1.,
         mask=MASKS[mask])


def test_masked_mean_and_reduce_loss():
    x = RNG.randn(6, 5, 2).astype(np.float32)
    for mask in (None, MASKS['rows'], MASKS['elements'], MASKS['empty']):
        _run('masked_mean', [x], mask=mask)
    with pytest.raises(ValueError):
        tl.reduce_loss(torch.zeros(2), 'median')
    assert float(tl.masked_mean(torch.ones(3), torch.zeros(3, dtype=torch.bool))) == 0.


def test_loss_dict_helpers_and_classes():
    d = {}
    tl.add_to_loss_dict(d, 'a', torch.tensor(float('nan')))
    tl.add_to_loss_dict(d, 'a', torch.tensor(2.), weight=3.)
    tl.add_to_loss_dict(d, '_aux', torch.tensor(5.))
    tl.add_to_loss_dict(d, 'b', None)
    assert float(d['a']) == 6. and 'b' not in d
    assert float(tl.reduce_loss_dict(d, 2.)) == 3.
    logits, t = torch.from_numpy(X), torch.from_numpy(T01)
    assert torch.equal(tl.SigmoidFocalLoss(alpha=.5)(logits, t),
                       tl.sigmoid_focal_loss(logits, t, alpha=.5))
    assert 'IoULoss' in repr(tl.IoULoss(min_size=1.))


def test_r1_regularization_matches_jax():
    w = RNG.randn(5, 3).astype(np.float32)
    x = RNG.randn(4, 5).astype(np.float32)
    want = jl.r1_regularization(lambda p, z: jnp.tanh(z @ p), jnp.asarray(w), jnp.asarray(x),
                                gamma=2.)
    got = tl.r1_regularization(lambda p, z: torch.tanh(z @ p), torch.from_numpy(w),
                               torch.from_numpy(x), gamma=2.)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
