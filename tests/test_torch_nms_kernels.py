"""Each NMS kernel against its plain version, on the card.

The kernels are ``csrc/nms_bits.cu`` and ``csrc/nms_resolve.cu``, their plain
versions in ``kernels/nms.py``; ``kernels.LAUNCHES`` counts the launches. Every test here needs a CUDA card and skips
without one. The module imports neither JAX nor the JAX package, so on a
machine with a card it runs without the repository's conftest:
``python -m pytest --noconftest tests/test_torch_nms_kernels.py -m cuda``.
"""
import numpy as np
import pytest
import torch

from celldetection_tpu_torch.kernels import LAUNCHES, nms_bits_count, nms_bits_fill, nms_resolve
from celldetection_tpu_torch.kernels.nms import (BLOCK, _nms_sweep, _suppression_counts,
                                                 band_plan, bits_sweep, large_layout, nms_sweep,
                                                 slots_layout)
from celldetection_tpu_torch.ops import nms_padded
from celldetection_tpu_torch.ops.boxes import sort_by_score

pytestmark = pytest.mark.cuda

NMS_LAUNCHES = ('cdt_nms_bits_count', 'cdt_nms_bits_fill', 'cdt_nms_resolve')


def crowded_boxes(seed, shape, extent, invalid=0.05):
    rng = np.random.RandomState(seed)
    centers = rng.rand(*shape, 2) * extent
    sizes = rng.rand(*shape, 2) * 20 + 2
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], -1).astype(np.float32)
    return boxes, rng.rand(*shape).astype(np.float32), rng.rand(*shape) > invalid


def canonical(pairs, shape):
    """Pairs ordered by block-major row and word, as the plain version orders
    them (the kernel's order inside a row is not fixed)."""
    bsz, m = shape
    row = pairs[:, 1] & 0xffffffff
    q = ((row % m) // BLOCK * bsz + row // m) * BLOCK + row % m % BLOCK
    return pairs[torch.argsort((q << 32) | (pairs[:, 1] >> 32))]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the NMS kernels have no CPU mode')
    return torch.device('cuda')


@pytest.mark.parametrize('seed, shape, extent, thresh', [
    (0, (4, 2048), 200., 0.2), (1, (1, 16384), 800., 0.5), (2, (2, 300), 100., 0.8)])
def test_each_nms_kernel_matches_plain_on_card(card, seed, shape, extent, thresh):
    arrays = crowded_boxes(seed, shape, extent)
    boxes, scores, valid = (torch.from_numpy(a).to(card) for a in arrays)
    _, b, v = sort_by_score(boxes, scores, valid)
    bc, vc = b.cpu(), v.cpu()
    nb = -(-shape[1] // BLOCK)
    before = [LAUNCHES[name] for name in NMS_LAUNCHES]

    want = nms_bits_count(bc, vc, thresh)
    want_pairs = nms_bits_fill(bc, vc, thresh, 0, nb, None, None, 0, 0)
    layouts = ['packed'] + (['slots'] if slots_layout(*shape) else [])
    for layout in layouts:
        packed = layout == 'packed'
        start, diag, flags, nxt = nms_bits_count(b, v, thresh, packed=packed)
        for got, w in zip((start, diag, flags, nxt), want):
            assert got is None if not packed and got is not diag else torch.equal(got.cpu(), w)
        offsets = start.cumsum(0) if packed else None
        (r0, r1, base, size), = band_plan(offsets, *shape)   # one band at these shapes
        pairs = nms_bits_fill(b, v, thresh, r0, r1, flags, offsets, base, size)
        # slots: the zero slots are no pairs; packed: the room past the pairs is unwritten
        found = pairs[pairs[:, 0] != 0] if not packed else pairs[:int(offsets[-1])]
        assert torch.equal(canonical(found, shape).cpu(), want_pairs), layout
        removed = torch.zeros(shape[0], nb, dtype=torch.int64, device=card)
        keep = torch.zeros_like(v)
        want_removed, want_keep = removed.cpu(), keep.cpu()
        nms_resolve(v, diag, nxt, pairs, offsets, 0, removed, keep, 0, nb)
        nms_resolve(vc, want[1], None, found.cpu(), None, 0, want_removed, want_keep, 0, nb)
        assert torch.equal(keep.cpu(), want_keep) and torch.equal(removed.cpu(), want_removed)
    assert [LAUNCHES[name] for name in NMS_LAUNCHES] == [n + len(layouts) for n in before]

    assert torch.equal(nms_sweep(b, v, thresh), _nms_sweep(b, v, thresh))
    cpu = nms_padded(*(torch.from_numpy(a) for a in arrays), thresh)
    np.testing.assert_array_equal(nms_padded(boxes, scores, valid, thresh).cpu().numpy(),
                                  cpu.numpy())


def test_banded_sweep_matches_plain_on_card(card):
    """Bands of a few row blocks each, the removed bits carried between them."""
    arrays = crowded_boxes(3, (2, 1000), 150.)
    _, b, v = sort_by_score(*(torch.from_numpy(a).to(card) for a in arrays))
    before = LAUNCHES['cdt_nms_resolve']
    assert torch.equal(bits_sweep(b, v, 0.5, pair_budget=50), _nms_sweep(b, v, 0.5))
    assert LAUNCHES['cdt_nms_resolve'] - before > 5


@pytest.mark.parametrize('seed, shape, extent', [(4, (2, 5000), 400.), (5, (1, 20000), 900.)])
def test_large_layout_matches_plain_on_card(card, seed, shape, extent):
    """The layout of images above 262,144 boxes (bit flags, the resolve's
    variant with a shallower ring), forced at small N: the count against its
    plain version, the sweep against ``_nms_sweep`` in one band and in many."""
    arrays = crowded_boxes(seed, shape, extent)
    _, b, v = sort_by_score(*(torch.from_numpy(a).to(card) for a in arrays))
    got = nms_bits_count(b, v, 0.5, large=True)
    for g, w in zip(got, _suppression_counts(b, v, 0.5, large=True)):
        assert torch.equal(g, w)
    nb = -(-shape[1] // BLOCK)
    assert got[2].dtype == torch.int32 and got[2].numel() == shape[0] * nb * -(-nb // 32)
    want = _nms_sweep(b, v, 0.5)
    before = LAUNCHES['cdt_nms_resolve']
    assert torch.equal(bits_sweep(b, v, 0.5, large=True), want)
    assert torch.equal(bits_sweep(b, v, 0.5, pair_budget=500, large=True), want)
    assert LAUNCHES['cdt_nms_resolve'] - before > 2


def test_sweep_past_262144_boxes_matches_plain_on_card(card):
    """The smallest image that takes the large layout by itself."""
    n = 262_145
    assert large_layout(n) and not large_layout(n - 1)
    _, b, v = sort_by_score(*(torch.from_numpy(a).to(card)
                              for a in crowded_boxes(6, (1, n), 3200.)))
    assert torch.equal(nms_sweep(b, v, 0.5), _nms_sweep(b, v, 0.5))
