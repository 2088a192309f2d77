"""Port parity: exact greedy NMS (``ops/boxes.py``) and its CUDA kernel's wrapper.

On the CPU the port's ``nms_padded`` runs the plain sweep ``_nms_sweep``; it
must give the JAX package's keep masks bit for bit. Where N >= 2048 the JAX
package runs its XLA ``_nms_sweep`` on the CPU, which
``kernels/nms_pallas.py`` states matches the Pallas kernel bit for bit; the
kernel itself is also run here in interpret mode at N = 2048. The CUDA
kernels are held against the plain sweep in the test marked ``cuda``, and
each against its own plain version in ``tests/test_torch_nms_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celldetection_tpu.kernels.nms_pallas import nms_pallas
from celldetection_tpu.ops import batched_box_nms as jax_batched_box_nms
from celldetection_tpu.ops.boxes import _suppression_matrix as jax_suppression_matrix
from celldetection_tpu.ops.boxes import nms_padded as jax_nms_padded
from celldetection_tpu_torch.kernels import LAUNCHES, nms_sweep
from celldetection_tpu_torch.kernels.nms import _nms_sweep
from celldetection_tpu_torch.ops import batched_box_nms, nms_padded
from celldetection_tpu_torch.ops.boxes import sort_by_score
from test_torch_port_cpn import one_torch_thread  # noqa: F401  (pytestmark)

pytestmark = pytest.mark.usefixtures('one_torch_thread')


def crowded_boxes(seed, shape, extent=200., invalid=0.05):
    rng = np.random.RandomState(seed)
    centers = rng.rand(*shape, 2) * extent
    sizes = rng.rand(*shape, 2) * 20 + 2
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], -1).astype(np.float32)
    return boxes, rng.rand(*shape).astype(np.float32), rng.rand(*shape) > invalid


def knife_edge_pairs(seed, thresh, pairs=256):
    """A box and its own left part of relative width ``thresh``: IoU is
    exactly ``thresh`` in real arithmetic; the first pairs have integer corners."""
    rng = np.random.RandomState(seed)
    gx, gy = np.divmod(np.arange(pairs), 16)
    x = 100. * gx + rng.rand(pairs) * 50
    y = 100. * gy + rng.rand(pairs) * 50
    w, h = rng.rand(pairs) * 30 + 1, rng.rand(pairs) * 30 + 1
    x[:16], y[:16], w[:16], h[:16] = np.floor(x[:16]), np.floor(y[:16]), 10., np.floor(h[:16]) + 1
    a = np.stack([x, y, x + w, y + h], -1)
    b = np.stack([x, y, x + w * thresh, y + h], -1)
    boxes = np.stack([a, b], 1).reshape(2 * pairs, 4).astype(np.float32)
    return boxes, rng.rand(2 * pairs).astype(np.float32), np.ones(2 * pairs, bool)


def port(fn, arrays, thresh):
    return fn(*(torch.from_numpy(a) for a in arrays), thresh).numpy()


def ref(fn, arrays, thresh):
    return np.asarray(fn(*(jnp.asarray(a) for a in arrays), thresh))


@pytest.mark.parametrize('thresh', [0.2, 0.5, 0.8])
def test_batched_nms_matches_jax(thresh):
    arrays = crowded_boxes(int(thresh * 10), (3, 2048))
    want = ref(jax_batched_box_nms, arrays, thresh)
    got = port(batched_box_nms, arrays, thresh)
    np.testing.assert_array_equal(got, want)
    assert not got[~arrays[2]].any()
    assert 0 < got.sum() < arrays[2].sum()


def test_nms_matches_jax_at_16384():
    arrays = crowded_boxes(16, (16384,), extent=800.)
    np.testing.assert_array_equal(port(nms_padded, arrays, 0.5), ref(jax_nms_padded, arrays, 0.5))


def test_nms_matches_pallas_kernel_interpret():
    """The TPU kernel this port replaces, run in interpret mode at N = 2048."""
    arrays = crowded_boxes(3, (2048,))
    want = np.asarray(nms_pallas(*(jnp.asarray(a) for a in arrays), iou_threshold=0.2,
                                 interpret=True))
    np.testing.assert_array_equal(port(nms_padded, arrays, 0.2), want)


@pytest.mark.parametrize('thresh', [0.2, 0.5, 0.8])
def test_knife_edge_pairs_match_jax(thresh):
    """IoU exactly at the threshold: the port decides each pair as the JAX
    package's ``_suppression_matrix`` does when run op by op (each fp32
    operation rounded on its own). Inside one fused XLA CPU program the same
    expression rounds differently on a few of these pairs, depending on the
    shapes it is fused with, so the oracle here is a plain greedy pass over
    the op-by-op matrix."""
    boxes, scores, valid = knife_edge_pairs(7, thresh)
    sup = np.asarray(jax_suppression_matrix(jnp.asarray(boxes), jnp.asarray(boxes), thresh))
    want = np.zeros_like(valid)
    kept = []
    for i in np.argsort(-np.where(valid, scores, -np.inf), kind='stable'):
        if valid[i] and not sup[kept, i].any():
            kept.append(i)
    want[kept] = True
    got = port(nms_padded, (boxes, scores, valid), thresh)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)


@pytest.mark.parametrize('case', ['n300', 'n1', 'n0', 'all_invalid', 'ties'])
def test_nms_edge_cases_match_jax(case):
    arrays = crowded_boxes(1, (300,), extent=100.)
    if case == 'n1':
        arrays = tuple(a[:1] for a in arrays)
    elif case == 'n0':
        arrays = tuple(a[:0] for a in arrays)
    elif case == 'all_invalid':
        arrays = arrays[0], arrays[1], np.zeros(300, bool)
    elif case == 'ties':   # saturated scores: the lower index is visited first
        arrays = arrays[0], np.ones(300, np.float32), arrays[2]
    got = port(nms_padded, arrays, 0.5)
    assert got.shape == arrays[2].shape and got.dtype == np.bool_
    if case == 'n0':
        return
    np.testing.assert_array_equal(got, ref(jax_nms_padded, arrays, 0.5))


def test_sort_by_score_is_stable_descending():
    scores = torch.tensor([[0.5, 1.0, 1.0, 0.2, 1.0]])
    valid = torch.tensor([[True, True, False, True, True]])
    boxes = torch.arange(20, dtype=torch.float32).reshape(1, 5, 4)
    order, b, v = sort_by_score(boxes, scores, valid)
    assert order.tolist() == [[1, 4, 0, 3, 2]]
    assert torch.equal(b[0, 0], boxes[0, 1]) and v.tolist() == [[True, True, True, True, False]]


def test_nms_sweep_wrapper_routes_by_device():
    """CPU tensors take the plain sweep and count no kernel launch; other
    non-CUDA devices raise rather than fall back."""
    boxes, _, valid = crowded_boxes(2, (2, 300))
    b, v = torch.from_numpy(boxes), torch.from_numpy(valid)
    before = LAUNCHES.copy()
    assert torch.equal(nms_sweep(b, v, 0.5), _nms_sweep(b, v, 0.5))
    assert LAUNCHES == before
    with pytest.raises(ValueError, match='no kernel'):
        nms_sweep(b.to('meta'), v.to('meta'), 0.5)


@pytest.mark.cuda
def test_nms_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the NMS kernel has no CPU mode')
    for seed, shape, thresh in ((0, (4, 2048), 0.2), (1, (1, 16384), 0.5), (2, (2, 300), 0.8)):
        arrays = crowded_boxes(seed, shape, extent=200. * (shape[1] // 2048 or 1))
        boxes, scores, valid = (torch.from_numpy(a).cuda() for a in arrays)
        _, b, v = sort_by_score(boxes, scores, valid)
        before = LAUNCHES.copy()
        keep = nms_sweep(b, v, thresh)
        assert LAUNCHES - before == {name: 1 for name in (                 # one band
            'cdt_nms_bits_count', 'cdt_nms_bits_fill', 'cdt_nms_resolve')}
        assert torch.equal(keep, _nms_sweep(b, v, thresh))
        np.testing.assert_array_equal(nms_padded(boxes, scores, valid, thresh).cpu().numpy(),
                                      port(nms_padded, arrays, thresh))
