"""Port parity: the plain versions of the NMS kernels' two halves (``kernels/nms.py``).

The suppression bits (``_suppression_counts``, ``_suppression_pairs``) are
held against the JAX package's ``_suppression_matrix`` restricted to later,
valid columns; the resolve over them (``kernels.nms.bits_sweep`` on CPU
tensors, which runs every kernel wrapper's plain version) against JAX
``batched_box_nms`` and ``nms_padded``, banded and not. The kernels
themselves are held against these plain versions on the card by
``tests/test_torch_nms_kernels.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celldetection_tpu.ops import batched_box_nms as jax_batched_box_nms
from celldetection_tpu.ops.boxes import _suppression_matrix as jax_suppression_matrix
from celldetection_tpu.ops.boxes import nms_padded as jax_nms_padded
from celldetection_tpu_torch.kernels import LAUNCHES
from celldetection_tpu_torch.kernels.nms import (BLOCK, _nms_sweep, _suppression_counts,
                                                 _suppression_pairs, _unpack_words, band_plan,
                                                 bits_sweep, large_layout, pair_bands,
                                                 slots_layout)
from celldetection_tpu_torch.ops.boxes import sort_by_score
from test_torch_port_nms import crowded_boxes, knife_edge_pairs


def unpacked(b, v, thresh):
    """The plain words of every row, unpacked: ``[B, M, M]`` bool."""
    bsz, m = v.shape
    nb = -(-m // BLOCK)
    start, diag, flags, nxt = _suppression_counts(b, v, thresh)
    pairs = _suppression_pairs(b, v, thresh, 0, nb)
    row, word = pairs[:, 1] & 0xffffffff, pairs[:, 1] >> 32
    is_next = word == row % m // BLOCK + 1
    want_nxt = torch.zeros(bsz * m, dtype=torch.int64)
    want_nxt[row[is_next]] = pairs[is_next, 0]
    assert torch.equal(nxt[:, :m].flatten(), want_nxt) and not nxt[:, m:].any()
    counts = start[1:].view(nb, bsz, BLOCK).transpose(0, 1).reshape(bsz, -1)[:, :m]
    assert start[0] == 0 and torch.equal(counts.flatten(), torch.bincount(row, minlength=bsz * m))
    want_flags = torch.zeros(bsz, nb, nb, dtype=torch.uint8)
    want_flags[row // m, row % m // BLOCK, word] = 1
    assert torch.equal(flags, want_flags.flatten())
    dense = torch.zeros(bsz, m, nb, BLOCK, dtype=torch.bool)
    dense[row // m, row % m, word] = _unpack_words(pairs[:, 0])
    dense = dense.flatten(2)
    assert not dense[:, :, m:].any()
    # the diagonal blocks: column words, bit l of box j's word for box 64 * (j // 64) + l,
    # and box j's own bit for its validity
    i = torch.arange(m)
    assert not diag[:, m:].any()
    cols = _unpack_words(diag[:, :m])                            # [B, M, 64]
    own = torch.nn.functional.one_hot(i % BLOCK, BLOCK).bool()
    assert torch.equal(cols[:, own], v)
    dense[:, (i // BLOCK * BLOCK)[:, None] + torch.arange(BLOCK), i[:, None]] |= cols & ~own
    return dense[:, :, :m]


def sweep(arrays, thresh, **kw):
    """``nms_padded`` with the sweep of the kernels, on CPU tensors (their plain versions)."""
    boxes, scores, valid = (torch.from_numpy(a) for a in arrays)
    order, b, v = sort_by_score(boxes, scores, valid)
    keep = bits_sweep(b, v, thresh, **kw)
    return (torch.zeros_like(valid).scatter_(1, order, keep) & valid).numpy()


@pytest.mark.parametrize('thresh', [0.2, 0.5, 0.8])
def test_packed_words_match_jax_suppression_matrix(thresh):
    boxes, _, valid = crowded_boxes(int(thresh * 10) + 20, (3, 2048))
    got = unpacked(torch.from_numpy(boxes), torch.from_numpy(valid), thresh).numpy()
    later = np.triu(np.ones((2048, 2048), bool), 1)
    for img in range(3):
        sup = np.asarray(jax_suppression_matrix(jnp.asarray(boxes[img]), jnp.asarray(boxes[img]),
                                                thresh))
        want = sup & later & valid[img][:, None] & valid[img][None, :]
        np.testing.assert_array_equal(got[img], want)
    assert got.any()


@pytest.mark.parametrize('thresh', [0.2, 0.5, 0.8])
def test_plain_resolve_matches_jax_batched(thresh):
    arrays = crowded_boxes(int(thresh * 10) + 30, (3, 2048))
    want = np.asarray(jax_batched_box_nms(*(jnp.asarray(a) for a in arrays), thresh))
    got = sweep(arrays, thresh)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < arrays[2].sum()


def test_plain_resolve_matches_jax_at_4096():
    arrays = crowded_boxes(40, (4096,), extent=400.)
    want = np.asarray(jax_nms_padded(*(jnp.asarray(a) for a in arrays), 0.5))
    np.testing.assert_array_equal(sweep(tuple(a[None] for a in arrays), 0.5)[0], want)


@pytest.mark.parametrize('budget', [0, 50, 200])
def test_banding_matches_unbanded(budget):
    """Bands of one to a few row blocks, at a ragged N = 1000, with the
    removed bits carried from band to band: the same keep mask as one band."""
    arrays = crowded_boxes(3, (2, 1000), extent=150.)
    boxes, scores, valid = (torch.from_numpy(a) for a in arrays)
    _, b, v = sort_by_score(boxes, scores, valid)
    start = _suppression_counts(b, v, 0.5)[0]
    ends = start.cumsum(0)[2 * BLOCK::2 * BLOCK].tolist()     # each row block's end offset
    assert len(ends) == 16 and len(pair_bands(ends, budget)) >= 2
    want = sweep(arrays, 0.5)
    np.testing.assert_array_equal(sweep(arrays, 0.5, pair_budget=budget), want)
    np.testing.assert_array_equal(want, torch.zeros_like(valid).scatter_(
        1, sort_by_score(boxes, scores, valid)[0], _nms_sweep(b, v, 0.5)).numpy() & arrays[2])


@pytest.mark.parametrize('budget', [0, 200, 2 * BLOCK * 16 * 15 // 2])
def test_band_plan(budget):
    """One band of the whole bound in the slots layout and where the bound
    fits the budget, else the bands of ``pair_bands`` with each band's first
    offset and exact size."""
    boxes, scores, valid = (torch.from_numpy(a) for a in crowded_boxes(3, (2, 1000), extent=150.))
    _, b, v = sort_by_score(boxes, scores, valid)
    start = _suppression_counts(b, v, 0.5)[0].cumsum(0)
    ends = start[2 * BLOCK::2 * BLOCK].tolist()
    plan = band_plan(start, 2, 1000, budget)
    bound = 2 * BLOCK * 16 * 15 // 2
    assert band_plan(None, 2, 1000, budget) == [(0, 16, 0, bound)]
    assert slots_layout(2, 1000, budget) == (budget >= bound)
    if budget == bound:
        assert plan == [(0, 16, 0, bound)]
    else:
        assert [(r0, r1) for r0, r1, _, _ in plan] == pair_bands(ends, budget)
        assert all(base == (ends[r0 - 1] if r0 else 0) and size == ends[r1 - 1] - base
                   for r0, r1, base, size in plan)
        assert sum(size for *_, size in plan) == ends[-1]


def test_slots_layout_up_to_2048_boxes():
    assert slots_layout(4, 2048) and slots_layout(56, 2048) and slots_layout(1, 1)
    assert not slots_layout(1, 2049) and not slots_layout(1, 16384)
    assert not slots_layout(2048, 2048)               # every later word: above the budget


def test_pair_bands():
    assert pair_bands([]) == []
    assert pair_bands([5, 5, 5], 0) == [(0, 1), (1, 3)]       # blocks without pairs merge
    assert pair_bands([3, 6, 9, 12], 6) == [(0, 2), (2, 4)]
    assert pair_bands([10, 11, 30], 5) == [(0, 1), (1, 2), (2, 3)]  # over budget: alone
    assert pair_bands([1, 2, 3], 10) == [(0, 3)]


@pytest.mark.parametrize('thresh', [0.2, 0.5, 0.8])
def test_knife_edge_pairs_resolve_like_op_by_op_oracle(thresh):
    """IoU exactly at the threshold: the words round as JAX's
    ``_suppression_matrix`` op by op (see ``test_torch_port_nms.py``)."""
    boxes, scores, valid = knife_edge_pairs(7, thresh)
    sup = np.asarray(jax_suppression_matrix(jnp.asarray(boxes), jnp.asarray(boxes), thresh))
    want = np.zeros_like(valid)
    kept = []
    for i in np.argsort(-np.where(valid, scores, -np.inf), kind='stable'):
        if valid[i] and not sup[kept, i].any():
            kept.append(i)
    want[kept] = True
    got = sweep((boxes[None], scores[None], valid[None]), thresh)[0]
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)


@pytest.mark.parametrize('case', ['n300', 'n1', 'all_invalid', 'ties'])
def test_plain_resolve_edge_cases_match_jax(case):
    arrays = crowded_boxes(1, (300,), extent=100.)
    if case == 'n1':
        arrays = tuple(a[:1] for a in arrays)
    elif case == 'all_invalid':
        arrays = arrays[0], arrays[1], np.zeros(300, bool)
    elif case == 'ties':
        arrays = arrays[0], np.ones(300, np.float32), arrays[2]
    want = np.asarray(jax_nms_padded(*(jnp.asarray(a) for a in arrays), 0.5))
    np.testing.assert_array_equal(sweep(tuple(a[None] for a in arrays), 0.5)[0], want)


def test_plain_kernels_count_no_launch():
    before = LAUNCHES.copy()
    sweep(crowded_boxes(2, (2, 300)), 0.5)
    assert LAUNCHES == before


@pytest.mark.parametrize('shape', [(2, 1000), (1, 2500), (3, 64 * 33)])
def test_large_layout_flags_are_the_byte_flags_as_bits(shape):
    """Images above 262,144 boxes keep one bit per block pair: bit c % 32 of
    int32 word c / 32 of each row block (bit 31 the sign bit)."""
    boxes, scores, valid = (torch.from_numpy(a) for a in crowded_boxes(5, shape, extent=150.))
    _, b, v = sort_by_score(boxes, scores, valid)
    bsz, nb = shape[0], -(-shape[1] // BLOCK)
    small = _suppression_counts(b, v, 0.5)
    large = _suppression_counts(b, v, 0.5, large=True)
    for got, want in zip(large, small):
        if got.dtype != torch.int32:
            assert torch.equal(got, want)
    words = large[2].view(bsz, nb, -(-nb // 32)).long() & 0xffffffff
    bits = (words[..., None] >> torch.arange(32)) & 1 == 1
    assert torch.equal(bits.flatten(2)[..., :nb], small[2].view(bsz, nb, nb).bool())
    assert not bits.flatten(2)[..., nb:].any() and small[2].any()


@pytest.mark.parametrize('budget', [0, 300, 10 ** 9])
def test_large_layout_sweep_matches_plain(budget):
    """The large layout through every wrapper's plain version, banded and not."""
    assert large_layout(64 * 4097) and not large_layout(64 * 4096)
    arrays = crowded_boxes(6, (2, 1500), extent=200.)
    _, b, v = sort_by_score(*(torch.from_numpy(a) for a in arrays))
    np.testing.assert_array_equal(bits_sweep(b, v, 0.5, pair_budget=budget, large=True).numpy(),
                                  _nms_sweep(b, v, 0.5).numpy())
