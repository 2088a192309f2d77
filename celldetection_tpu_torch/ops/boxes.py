"""Box math and exact greedy NMS (plain PyTorch).

Counterpart of ``celldetection_tpu/ops/boxes.py``: ``box_area`` (79),
``_suppression_matrix`` (95-109), ``nms_padded`` (147-191) and ``_nms_sweep``
(216-250). ``_nms_sweep`` is the plain version of the whole sweep that the
hand-written CUDA kernels of :mod:`..kernels.nms` do, and ``nms_padded`` on
CPU tensors is the oracle they are held against. ``_suppression_counts``,
``_suppression_pairs`` and ``_resolve_blocks`` are the plain versions of the
kernels one by one, with the same contracts.

Unlike the JAX package there is no size gate: on a CUDA tensor the kernel
runs for every N; on a CPU tensor the plain sweep runs.
"""
import torch

__all__ = ['box_area', 'sort_by_score', 'nms_padded']


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def _suppression_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor, thresh: float) -> torch.Tensor:
    """``IoU > thresh`` as ``inter > thresh * union``, ``[..., n, m]`` bool.

    The multiply form with ``union = (area1 + area2) - inter``, in that order,
    is the one the JAX sweep, the Pallas kernel and the CUDA kernel all use,
    so all of them round identically on knife-edge IoUs.
    """
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = (area1[..., :, None] + area2[..., None, :]) - inter
    return torch.where(union > 0, inter, 0.) > thresh * union


def _nms_sweep(b: torch.Tensor, v: torch.Tensor, iou_threshold: float,
               tile: int = 128) -> torch.Tensor:
    """Blocked greedy suppression sweep over score-descending boxes.

    Args:
        b: ``[B, M, 4]`` boxes, each row sorted by descending score.
        v: ``[B, M]`` bool validity.

    Returns:
        Keep mask ``[B, M]`` in the given (sorted) order.
    """
    bsz, m = v.shape
    pad = (-m) % tile
    if pad:
        b = torch.cat([b, b.new_zeros(bsz, pad, 4)], 1)
        v = torch.cat([v, v.new_zeros(bsz, pad)], 1)
    keep = v.clone()
    later_than = torch.ones(tile, tile, dtype=torch.bool, device=b.device).triu(1)
    for start in range(0, m + pad, tile):
        stop = start + tile
        rows = b[:, start:stop]
        k = keep[:, start:stop]
        sup_rr = _suppression_matrix(rows, rows, iou_threshold) & later_than
        for j in range(tile):  # sequential greedy inside the tile
            k = k & ~(sup_rr[:, j] & k[:, j:j + 1])
        keep[:, start:stop] = k
        if stop < m + pad:  # suppress strictly later boxes against kept rows
            sup = _suppression_matrix(rows, b[:, stop:], iou_threshold) & k[:, :, None]
            keep[:, stop:] &= ~sup.any(1)
    return keep[:, :m]


# The sweep of the CUDA kernels in two halves, in plain PyTorch: the
# suppression bits (csrc/nms_bits.cu) and the resolve (csrc/nms_resolve.cu).
# Boxes go in blocks of BLOCK; word (i, c) has bit l set iff box 64c + l comes
# after row i and both are valid and i suppresses it. torch has no uint64
# bitwise operations, so words are int64 (bit 63 is the sign bit). A pair
# is one row of an int64 [P, 2] tensor: (bits, row | word << 32), where row
# is b * M + i; it has the layout of the kernels' 16-byte Pair. Pairs and
# their offsets go row by row in block-major order: q = (r * B + b) * 64 + l
# for row l of block r of image b, so a band of row blocks is one range.
BLOCK = 64
_CHUNK = 2 ** 22   # pair tests per step of the plain bits, bounding its temporaries


def _unpack_words(words: torch.Tensor) -> torch.Tensor:
    """``[...]`` int64 words to ``[..., 64]`` bool, bit l at position l."""
    return (words[..., None] >> torch.arange(BLOCK, device=words.device)) & 1 == 1


def _pack_words(bits: torch.Tensor) -> torch.Tensor:
    """``[..., 64 * W]`` bool to ``[..., W]`` int64 words (a sum of distinct powers is their OR)."""
    b = bits.unflatten(-1, (-1, BLOCK)).long()
    return (b << torch.arange(BLOCK, device=bits.device)).sum(-1)


def _later_words(b: torch.Tensor, v: torch.Tensor, thresh: float, r0: int, r1: int):
    """The words of rows in blocks ``[r0, r1)`` against every block from their own on.

    Yields ``(i, c, words)`` per step: row indices ``i [R]``, column block
    indices ``c [W]`` and ``words [B, R, W]`` int64, masked as the kernels
    mask them. Steps are cut so that no temporary exceeds ``_CHUNK`` tests
    per image pair (never ``[M, M]``).
    """
    bsz, m = v.shape
    nb = -(-m // BLOCK)
    pad = nb * BLOCK - m
    bp = torch.cat([b, b.new_zeros(bsz, pad, 4)], 1)
    vp = torch.cat([v, v.new_zeros(bsz, pad)], 1)
    rows = min(max(BLOCK, _CHUNK // (bsz * 2048) // BLOCK * BLOCK), (r1 - r0) * BLOCK)
    for i0 in range(r0 * BLOCK, min(r1 * BLOCK, m), rows):
        i = torch.arange(i0, min(i0 + rows, r1 * BLOCK, m), device=b.device)
        for j0 in range(i0 // BLOCK * BLOCK, nb * BLOCK, 2048):
            j = torch.arange(j0, min(j0 + 2048, nb * BLOCK), device=b.device)
            sup = _suppression_matrix(bp[:, i], bp[:, j], thresh)
            sup &= vp[:, i, None] & vp[:, None, j] & (j[None, :] > i[:, None])
            yield i, j[::BLOCK] // BLOCK, _pack_words(sup)


def _suppression_counts(b: torch.Tensor, v: torch.Tensor, thresh: float):
    """Plain version of ``csrc/nms_bits.cu``'s count kernel.

    Returns:
        ``(start, diag, flags, nxt)``: ``start [nb * B * 64 + 1]`` int64 holds
        0 and then the number of non-zero words of each row (block-major) in
        later blocks; ``diag [B, nb * 64]`` int64 each box's column word in its
        own block (bit l: box l of the block comes before it and suppresses it;
        its own bit: it is valid; 0 past M); ``nxt [B, nb * 64]`` int64 each
        row's word of the next block (0 in the last block and past M);
        ``flags [B * nb * nb]`` uint8 is 1 where row block r has a non-zero
        word in column block c > r.
    """
    bsz, m = v.shape
    nb = -(-m // BLOCK)
    counts = torch.zeros(bsz, nb * BLOCK, dtype=torch.int64, device=b.device)
    flags = torch.zeros(bsz, nb, nb, dtype=torch.bool, device=b.device)
    nxt = torch.zeros(bsz, nb * BLOCK, dtype=torch.int64, device=b.device)
    for i, c, words in _later_words(b, v, thresh, 0, nb):
        nxt[:, i] += (words * (c[None, :] == (i // BLOCK + 1)[:, None])).sum(-1)
        nz = (words != 0) & (c[None, :] > (i // BLOCK)[:, None])     # [B, R, W]
        counts[:, i] += nz.sum(-1)
        r0 = int(i[0]) // BLOCK
        nz = torch.nn.functional.pad(nz, (0, 0, 0, (-len(i)) % BLOCK))
        flags[:, r0:r0 + nz.shape[1] // BLOCK, c] |= nz.unflatten(1, (-1, BLOCK)).any(2)
    start = torch.zeros(nb * bsz * BLOCK + 1, dtype=torch.int64, device=b.device)
    start[1:] = counts.view(bsz, nb, BLOCK).transpose(0, 1).flatten()
    pad = nb * BLOCK - m
    bp = torch.cat([b, b.new_zeros(bsz, pad, 4)], 1).unflatten(1, (nb, BLOCK))
    vp = torch.cat([v, v.new_zeros(bsz, pad)], 1).unflatten(1, (nb, BLOCK))
    sup = _suppression_matrix(bp, bp, thresh) & vp[..., :, None] & vp[..., None, :]
    sup &= torch.ones(BLOCK, BLOCK, dtype=torch.bool, device=b.device).triu(1)
    sup |= torch.eye(BLOCK, dtype=torch.bool, device=b.device) & vp[..., :, None]  # own bit: valid
    diag = _pack_words(sup.transpose(-1, -2)).flatten(1)            # [B, nb * 64]
    return start, diag, flags.flatten().to(torch.uint8), nxt


def _suppression_pairs(b: torch.Tensor, v: torch.Tensor, thresh: float, r0: int, r1: int):
    """Plain version of ``csrc/nms_bits.cu``'s fill kernel, for row blocks ``[r0, r1)``.

    Returns:
        ``[P, 2]`` int64 pairs ``(bits, row | word << 32)`` of the rows' non-zero
        words in later blocks, ordered by block-major row and word.
    """
    bsz, m = v.shape
    found = []
    for i, c, words in _later_words(b, v, thresh, r0, r1):
        words = words * (c[None, :] > (i // BLOCK)[:, None])
        bi, ri, wi = words.nonzero(as_tuple=True)
        found.append(torch.stack([words[bi, ri, wi], (bi * m + i[ri]) | (c[wi] << 32)], 1))
    pairs = torch.cat(found) if found else b.new_zeros(0, 2, dtype=torch.int64)
    row = pairs[:, 1] & 0xffffffff
    q = ((row % m) // BLOCK * bsz + row // m) * BLOCK + row % m % BLOCK
    return pairs[torch.argsort((q << 32) | (pairs[:, 1] >> 32))]


def _resolve_blocks(v: torch.Tensor, diag: torch.Tensor, pairs: torch.Tensor,
                    removed: torch.Tensor, keep: torch.Tensor, r0: int, r1: int) -> None:
    """Plain version of ``csrc/nms_resolve.cu``: the greedy over row blocks ``[r0, r1)``.

    Updates in place ``keep [B, M]`` bool (the band's rows) and ``removed
    [B, nb]`` int64 (bit l of word c: box 64c + l is suppressed by a kept box
    of an earlier block), which is read only where ``r0 > 0`` and may be
    ``None`` where this band is the only one. ``pairs`` are those of the
    band's rows, in any order; pairs with no bits set are ignored. Validity
    comes from each box's own bit in ``diag``.
    """
    bsz, m = v.shape
    nb = -(-m // BLOCK)
    rem = torch.zeros(bsz, nb * BLOCK, dtype=torch.bool, device=v.device)
    if r0:
        rem = _unpack_words(removed).flatten(1)                     # [B, nb * 64]
    row = pairs[:, 1] & 0xffffffff
    img, i = row // m, row % m
    cols = (pairs[:, 1] >> 32)[:, None] * BLOCK + torch.arange(BLOCK, device=v.device)
    hit = _unpack_words(pairs[:, 0])                                # [P, 64]
    for r in range(r0, r1):
        s, e = r * BLOCK, min(r * BLOCK + BLOCK, m)
        d = _unpack_words(diag[:, s:e]).transpose(1, 2)             # [B, 64 rows, L columns]
        k = d.diagonal(0, 1, 2)[:, :e - s] & ~rem[:, s:e]           # own bits: valid
        d &= ~torch.eye(BLOCK, dtype=torch.bool, device=v.device)[:, :e - s]
        for j in range(e - s):          # sequential greedy inside the block
            k = k & ~(d[:, j] & k[:, j:j + 1])
        keep[:, s:e] = k
        mine = (i // BLOCK == r) & k[img, (i - s).clamp(0, e - s - 1)]
        sel = hit[mine]
        rem[img[mine, None].expand_as(sel)[sel], cols[mine][sel]] = True
    if removed is not None:
        removed.copy_(_pack_words(rem))


def sort_by_score(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor):
    """The greedy visit order of ``[B, N]`` boxes and the boxes in that order.

    A stable descending sort of ``where(valid, scores, -inf)``: ties keep the
    lower index first, as JAX's stable descending argsort.

    Returns:
        ``(order [B, N], boxes [B, N, 4], valid [B, N])``, the last two sorted.
    """
    neg = torch.full_like(scores, -torch.inf)
    order = torch.sort(torch.where(valid, scores, neg), dim=1, descending=True,
                       stable=True).indices
    b = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    return order, b, torch.gather(valid, 1, order)


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
               iou_threshold: float) -> torch.Tensor:
    """Exact greedy NMS on capacity-padded boxes.

    Boxes are visited in descending score order (stable: the lower index
    first on ties, as JAX's stable descending argsort); a box is kept iff its
    IoU with every kept higher-scoring box is <= ``iou_threshold``.

    Args:
        boxes: ``[N, 4]`` or ``[B, N, 4]`` (x0, y0, x1, y1).
        scores: ``[N]`` or ``[B, N]``.
        valid: ``[N]`` or ``[B, N]`` bool; padded entries False.

    Returns:
        Bool keep mask of ``valid``'s shape in the original box order. On a
        CUDA tensor all images go through one launch of the CUDA sweep.
    """
    from ..kernels.nms import nms_sweep

    if boxes.dim() == 2:
        return nms_padded(boxes[None], scores[None], valid[None], iou_threshold)[0]
    if valid.shape[1] == 0:
        return valid.clone()
    order, b, v = sort_by_score(boxes, scores, valid)
    keep_sorted = nms_sweep(b, v, iou_threshold)
    return torch.zeros_like(valid).scatter_(1, order, keep_sorted) & valid
