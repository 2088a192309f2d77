"""The frozen yardstick: the NMS bound against a hand count, the FLOPs against the head conv."""
import math

import pytest
import torch

from h100_bench import flops, roofline
from h100_bench.reference import cpn, cpn_u22, cpn_resnext101_unet
from h100_bench.tests.conftest import small_cell


def _hand_tests(b, v, keep, thresh):
    """Pair tests by hand: each kept box against every kept box before it; a
    suppressed valid box against the kept boxes before it up to its first suppressor."""
    tests = 0
    for i in range(b.shape[0]):
        kept = [j for j in range(b.shape[1]) if keep[i, j]]
        tests += len(kept) * (len(kept) - 1) // 2
        for j in range(b.shape[1]):
            if v[i, j] and not keep[i, j]:
                for c, k in enumerate(kept):
                    if k > j:
                        break
                    if roofline.suppression_matrix(b[i, k:k + 1], b[i, j:j + 1], thresh)[0, 0]:
                        tests += c + 1
                        break
    return tests


def test_nms_bound_counts_the_pair_tests_by_hand():
    g = torch.Generator().manual_seed(1)
    c = torch.rand(2, 300, 2, generator=g) * 100
    s = torch.rand(2, 300, 2, generator=g) * 20 + 2
    boxes = torch.cat([c, c + s], -1)
    scores = torch.rand(2, 300, generator=g)
    valid = torch.rand(2, 300, generator=g) > 0.2
    keep = torch.stack([cpn.greedy_nms(boxes[i], scores[i], valid[i], 0.2) for i in range(2)])
    sb, sv, order = roofline.sorted_inputs(boxes, scores, valid)
    sk = torch.gather(keep, 1, order)
    ms, what, tests = roofline.nms_bound(sb, sv, sk, 0.2)
    assert tests == _hand_tests(sb, sv, sk, 0.2) > 0
    assert what == 'operations'
    assert ms == pytest.approx(tests * roofline.PAIR_TEST_OPS / roofline.FP32_OPS_PER_S * 1e3)


def test_bound_of_picks_the_larger_time():
    assert roofline.bound_of(3.35e9, 0) == (pytest.approx(1.0), 'bytes')
    assert roofline.bound_of(0, 67e9) == (pytest.approx(1.0), 'operations')
    assert roofline.PEAK_FLOPS == {'fp32': 495e12, 'bf16': 989e12}


def test_u22_flops_hold_the_head_conv():
    cell = small_cell('u22_tiles_fp32_b1')
    total, by = flops.forward_flops(cpn_u22, cell.cfg, 1, 1024, 1024)
    head = 2 * 49 * 128 * 384 * 512 ** 2
    heads = sum(n for w, o, n in by if w[2:] == (7, 7) and o[2:] == (512, 512))
    assert heads == head
    assert 0.3 < head / total < 0.5
    assert total == sum(n for *_, n in by)
    # a 3x3 conv of the first block: 2 x 1024^2 x 64 x 3 x 9
    assert by[0][2] == 2 * 1024 ** 2 * 64 * 3 * 9


def test_resnext_flops_count_grouped_convs_per_group():
    cell = small_cell('rx101_tiles_bf16_b4')
    total, by = flops.forward_flops(cpn_resnext101_unet, cell.cfg, 1, 256, 256)
    grouped = [(w, o, n) for w, o, n in by if w[2:] == (3, 3) and w[1] * 32 == w[0]]
    assert grouped and all(n == 2 * math.prod(o) * w[1] * 9 for w, o, n in grouped)
    small = flops.forward_flops(cpn_resnext101_unet, cell.cfg, 1, 64, 64)[0]
    assert total == pytest.approx(16 * small, rel=0.01)
