"""Frozen yardstick arithmetic: the H100's peaks and the least time of a greedy NMS.

Peaks of one NVIDIA H100 SXM5 80GB (NVIDIA H100 Tensor Core GPU data sheet,
dense rates, without sparsity, at the 700 W power limit): HBM3 3.35 TB/s;
float32 outside the tensor cores 67 TFLOP/s; TF32 tensor cores 495 TFLOP/s;
bfloat16 989 TFLOP/s.

``nms_bound`` and ``bound_of`` are copies of ``chip_smoke.py``'s, counted
at the level of the algorithm, so that any implementation of the NMS is
held to the same least time: each box and valid flag read once and the
keep mask written once, and the pair tests these inputs need.
"""
import torch

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
PEAK_FLOPS = {'fp32': 495e12, 'bf16': 989e12}   # fp32 runs its convolutions in TF32
# fp32 operations of one box-pair test (4 min/max, 2 sub, 2 clamps, the
# intersection's mul, the union's add and sub, the threshold's mul, a select
# and the compare)
PAIR_TEST_OPS = 14
BLOCK = 64


def suppression_matrix(b1, b2, thresh):
    """``[n, m]`` bool: ``inter > thresh * union``, ``union = (area1 + area2) - inter``."""
    a1 = (b1[:, 2] - b1[:, 0]) * (b1[:, 3] - b1[:, 1])
    a2 = (b2[:, 2] - b2[:, 0]) * (b2[:, 3] - b2[:, 1])
    lt = torch.maximum(b1[:, None, :2], b2[None, :, :2])
    rb = torch.minimum(b1[:, None, 2:], b2[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = (a1[:, None] + a2[None, :]) - inter
    return torch.where(union > 0, inter, 0.) > thresh * union


def nms_bound(b, v, keep, thresh):
    """Least time (ms) for greedy NMS on these score-sorted inputs, what bounds
    it, and the pair tests counted.

    ``b [B, N, 4]``, ``v [B, N]`` and ``keep [B, N]`` in descending score
    order. Bytes: each box and valid flag read once, the keep mask written
    once. Operations: a kept box is tested against every kept box before it
    (k kept boxes: k (k - 1) / 2 tests), a suppressed one up to its first
    kept suppressor.
    """
    bsz, n = v.shape
    nbytes = bsz * n * (16 + 1 + 1)
    tests = 0
    for i in range(bsz):
        kept = keep[i].nonzero()[:, 0]
        if not len(kept):
            continue
        tests += len(kept) * (len(kept) - 1) // 2
        gone = (v[i] & ~keep[i]).nonzero()[:, 0]
        step = max(BLOCK, 2 ** 26 // len(kept))
        for c0 in range(0, len(gone), step):
            cols = gone[c0:c0 + step]
            sup = suppression_matrix(b[i, kept], b[i, cols], thresh)
            sup &= kept[:, None] < cols[None, :]
            first = sup.to(torch.uint8).argmax(0)
            tests += int(torch.where(sup.any(0), first + 1, 0).sum())
    return bound_of(nbytes, tests * PAIR_TEST_OPS) + (tests,)


def bound_of(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else 'operations')


def sorted_inputs(boxes, scores, valid):
    """``[B, N]`` inputs in greedy order: a stable descending sort of the valid scores."""
    order = torch.sort(torch.where(valid, scores, -torch.inf), dim=1, descending=True,
                       stable=True).indices
    return (torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)),
            torch.gather(valid, 1, order), order)
