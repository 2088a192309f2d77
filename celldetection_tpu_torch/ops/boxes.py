"""Box math and exact greedy NMS (plain PyTorch).

Counterpart of ``celldetection_tpu/ops/boxes.py``: ``box_area`` (79),
``box_iou`` (83-92), ``_suppression_matrix`` (95-109),
``_pairwise_inter_union``, ``pairwise_box_iou`` and
``pairwise_generalized_box_iou`` (112-137), ``remove_small_boxes_mask``
(140-144), ``nms_padded`` (147-191),
``_nms_sweep`` (216-250), ``nms_chunked`` (253-347), ``nms_indices``
(350-362), ``get_iou_voting`` and ``filter_by_box_voting`` (365-387), and
the reference's conveniences ``nms`` (30) and ``batched_box_nmsi`` (46)
over ``nms_indices`` and ``nms_chunked``.
``_nms_sweep`` is the plain version of the whole sweep that the hand-written
CUDA kernels of :mod:`..kernels.nms` do, and ``nms_padded`` on CPU tensors is
the oracle they are held against. ``_suppression_counts``,
``_suppression_pairs`` and ``_resolve_blocks`` are the plain versions of the
kernels one by one, with the same contracts.

Unlike the JAX package ``nms_padded`` has no size gate: on a CUDA tensor the
kernels run for every N up to ``kernels.nms.MAX_BOXES`` per image; on a CPU
tensor the plain sweep runs. ``nms_chunked`` takes the branches that the JAX
package takes on a TPU, on either device.
"""

import torch

from ..util.spans import span

__all__ = ['box_area', 'box_iou', 'pairwise_box_iou', 'pairwise_generalized_box_iou',
           'sort_by_score', 'nms_padded', 'nms_chunked', 'nms_indices',
           'remove_small_boxes_mask', 'get_iou_voting', 'filter_by_box_voting',
           'EXACT_NMS_MIN', 'EXACT_NMS_MAX', 'nms', 'batched_box_nmsi']

# nms_chunked's exact branch: above its chunk, an image of EXACT_NMS_MIN to
# EXACT_NMS_MAX boxes takes nms_padded whole, as the JAX package does on a TPU
# (ops/boxes.py:_use_pallas_sweep there, _PALLAS_NMS_MIN and _PALLAS_NMS_MAX);
# larger ones take the chunked approximation. A test may lower them.
EXACT_NMS_MIN = 2048
EXACT_NMS_MAX = 262_144


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Full IoU matrix ``[n, m]`` of two box sets (0 where the union is not positive)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[:, None] + area2[None, :] - inter
    return torch.where(union > 0, inter / union, 0.)


def _pairwise_inter_union(boxes1: torch.Tensor, boxes2: torch.Tensor):
    # clipped with maximum, whose derivative splits at a tie as jnp.clip's does
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = torch.maximum(rb - lt, lt.new_zeros(()))
    inter = wh[..., 0] * wh[..., 1]
    return inter, area1 + area2 - inter


def pairwise_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 0.) -> torch.Tensor:
    """Aligned (element-wise) IoU of two equal-length box sets ``[..., 4]``."""
    inter, union = _pairwise_inter_union(boxes1, boxes2)
    iou = inter / (union + eps)
    return torch.where(iou >= 0, iou, -iou)   # |iou| with jnp.abs's slope 1 at 0


def pairwise_generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor,
                                 eps: float = 0.) -> torch.Tensor:
    """Aligned generalized IoU of two equal-length box sets ``[..., 4]``."""
    inter, union = _pairwise_inter_union(boxes1, boxes2)
    iou = inter / (union + eps)
    lti = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rbi = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    whi = torch.maximum(rbi - lti, lti.new_zeros(()))
    areai = whi[..., 0] * whi[..., 1]
    return iou - (areai - union) / (areai + eps)


def remove_small_boxes_mask(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    """Bool mask of boxes with both sides >= ``min_size``."""
    ws = boxes[..., 2] - boxes[..., 0]
    hs = boxes[..., 3] - boxes[..., 1]
    return (ws >= min_size) & (hs >= min_size)


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


def _flag_bits(flags: torch.Tensor) -> torch.Tensor:
    """``[..., nb]`` bool to ``[..., ceil(nb / 32)]`` int32 words, bit c % 32 of word c / 32."""
    f = torch.nn.functional.pad(flags, (0, (-flags.shape[-1]) % 32)).unflatten(-1, (-1, 32))
    w = (f.long() << torch.arange(32, device=flags.device)).sum(-1)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)   # bit 31 is the sign bit


def _suppression_counts(b: torch.Tensor, v: torch.Tensor, thresh: float, large: bool = False):
    """Plain version of ``csrc/nms_bits.cu``'s count kernel.

    Args:
        large: the flags as bits, as the kernel writes them for large images.

    Returns:
        ``(start, diag, flags, nxt)``: ``start [nb * B * 64 + 1]`` int64 holds
        0 and then the number of non-zero words of each row (block-major) in
        later blocks; ``diag [B, nb * 64]`` int64 each box's column word in its
        own block (bit l: box l of the block comes before it and suppresses it;
        its own bit: it is valid; 0 past M); ``nxt [B, nb * 64]`` int64 each
        row's word of the next block (0 in the last block and past M);
        ``flags [B * nb * nb]`` uint8 is 1 where row block r has a non-zero
        word in column block c > r (large: bit c % 32 of int32 word
        ``(b * nb + r) * ceil(nb / 32) + c / 32``).
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
    flags = _flag_bits(flags) if large else flags.to(torch.uint8)
    return start, diag, flags.flatten(), nxt


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
               iou_threshold: float, sweep=None) -> torch.Tensor:
    """Exact greedy NMS on capacity-padded boxes.

    Boxes are visited in descending score order (stable: the lower index
    first on ties, as JAX's stable descending argsort); a box is kept iff its
    IoU with every kept higher-scoring box is <= ``iou_threshold``.

    Args:
        boxes: ``[N, 4]`` or ``[B, N, 4]`` (x0, y0, x1, y1).
        scores: ``[N]`` or ``[B, N]``.
        valid: ``[N]`` or ``[B, N]`` bool; padded entries False.
        sweep: The sweep over score-sorted boxes: ``kernels.nms.nms_sweep``
            (the kernels on a CUDA tensor) by default; ``_nms_sweep`` is its
            plain version on any device, which checks on the card pass.

    Returns:
        Bool keep mask of ``valid``'s shape in the original box order. On a
        CUDA tensor all images go through one call of the CUDA sweep.
    """
    from ..kernels.nms import nms_sweep

    if boxes.dim() == 2:
        return nms_padded(boxes[None], scores[None], valid[None], iou_threshold, sweep)[0]
    if valid.shape[1] == 0:
        return valid.clone()
    order, b, v = sort_by_score(boxes, scores, valid)
    keep_sorted = (sweep or nms_sweep)(b, v, iou_threshold)
    return torch.zeros_like(valid).scatter_(1, order, keep_sorted) & valid


def _traced(trace, name: str, shape, device, fn):
    """``fn()``; where ``trace`` is a list, also the span ``nms.<name>`` (count
    ``m``; its kernels' ``nms.*`` spans count their launches), ended by a
    device synchronisation, and an entry in ``trace``: the pass's name,
    ``B x M``, host ms (the span's) and kernel launches."""
    if trace is None:
        return fn()
    from ..kernels import KERNELS

    def sync():
        if device.type == 'cuda':
            torch.cuda.synchronize(device)

    sync()
    before = sum(k.launches for k in KERNELS)
    with span(f'nms.{name}', m=int(shape[1])) as sp:
        out = fn()
        sync()
        launches = sum(k.launches for k in KERNELS) - before
    trace.append(dict(name=name, batch=int(shape[0]), m=int(shape[1]), ms=sp.ms,
                      launches=launches))
    return out


def nms_chunked(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                iou_threshold: float, chunk: int = 16384, tile: int = 256,
                survivors_cap: int = None, return_overflow: bool = False, trace: list = None,
                sweep=None):
    """Greedy NMS for very large N (the cross-tile stitch), with the JAX package's branches on a TPU.

    * ``n <= chunk``: :func:`nms_padded`;
    * ``EXACT_NMS_MIN <= n <= EXACT_NMS_MAX``: :func:`nms_padded`, exact;
    * above: sort all boxes by score (stable, descending), cut them into
      score-contiguous chunks of ``chunk`` rows (rounded up to ``tile``, as
      the JAX package rounds it), sweep every chunk exactly in one batched
      :func:`..kernels.nms.nms_sweep`, then sweep the chunks' survivors, in
      score order, across the chunk borders. A box suppressed inside its
      chunk is not rescued when its suppressor loses the final pass: the
      approximation the JAX package makes.

    The cross-chunk pass holds ``survivors_cap`` rows (default ``4 * chunk``,
    at most ``n``, rounded up to ``tile``). It sweeps only the survivors: their
    count is read on the host once and the first ``min(count, cap)`` rows of
    the survivor order are swept; the rows past the count, which the JAX
    package carries as invalid, neither suppress nor are kept, so the keep
    set is the same.

    Args:
        boxes / scores / valid: ``[N, 4]``, ``[N]``, ``[N]`` bool.
        return_overflow: Also return whether more than ``cap`` boxes survived
            their chunks (the lowest-scored survivors were dropped).
        trace: a list to which each NMS pass appends its name, ``B x M``,
            host ms (synchronised; the span ``nms.exact``, ``nms.per-chunk``
            or ``nms.cross-chunk``) and kernel launches, and the chunked
            branch its survivor count.
        sweep: as :func:`nms_padded`'s, for every pass.

    Returns:
        Bool keep mask ``[N]`` in the original order (and the overflow flag,
        a Python bool).
    """
    n = boxes.shape[0]
    if n <= chunk or EXACT_NMS_MIN <= n <= EXACT_NMS_MAX:
        keep = _traced(trace, 'exact', (1, n), boxes.device,
                       lambda: nms_padded(boxes, scores, valid, iou_threshold, sweep))
        return (keep, False) if return_overflow else keep
    if sweep is None:
        from ..kernels.nms import nms_sweep as sweep

    chunk += (-chunk) % tile
    cap = min(survivors_cap or 4 * chunk, n)
    cap += (-cap) % tile
    s = torch.where(valid, scores, -torch.inf)
    order = torch.sort(s, descending=True, stable=True).indices
    order_p = torch.cat([order, order.new_zeros((-n) % chunk)])
    b, sp, v = boxes[order_p], s[order_p], valid[order_p]
    v[n:] = False
    num_chunks = len(order_p) // chunk
    keep = _traced(trace, 'per-chunk', (num_chunks, chunk), boxes.device,
                   lambda: sweep(b.view(num_chunks, chunk, 4), v.view(num_chunks, chunk),
                                 iou_threshold).reshape(-1))
    count = int(keep.sum())
    if trace is not None:
        trace.append(dict(name='survivors', count=count, cap=cap))
    m = min(count, cap)
    surv = torch.sort(torch.where(keep, sp, -torch.inf), descending=True,
                      stable=True).indices[:m]
    skeep = _traced(trace, 'cross-chunk', (1, m), boxes.device,
                    lambda: sweep(b[surv][None], keep[surv][None], iou_threshold)[0])
    out = torch.zeros_like(valid)
    out[order_p[surv]] = skeep
    out &= valid
    return (out, count > cap) if return_overflow else out


def nms_indices(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                iou_threshold: float):
    """NMS returning score-sorted keep indices (padded) and their validity.

    Returns:
        ``(indices, keep_valid)``, both ``[N]``: positions in the input sorted
        by descending score of the kept boxes (stable), and which are kept.
    """
    keep = nms_padded(boxes, scores, valid, iou_threshold)
    order = torch.sort(torch.where(keep, scores, -torch.inf), descending=True,
                       stable=True).indices
    return order, keep[order]


def _on_device(x, device):
    """A tensor stays on its own device unless ``device`` names one; any other
    input goes to ``resolve_device(device)``: the card unless the caller asks
    for the CPU, never a silent CPU run."""
    if torch.is_tensor(x) and device is None:
        return x
    from ..util.device import resolve_device
    return torch.as_tensor(x, device=resolve_device(device))


def nms(boxes, scores, iou_threshold: float, device=None):
    """torchvision-style NMS: the kept boxes' indices, by descending score, as
    host numpy (the reference's ``cd.ops.nms``). Tensors run on their own
    device (a CUDA tensor takes the NMS kernels), other inputs on ``device``,
    ``cuda`` by default. :func:`nms_padded` keeps everything on the device."""
    boxes = _on_device(boxes, device)
    scores = _on_device(scores, device).to(boxes.device)
    valid = torch.ones(boxes.shape[0], dtype=torch.bool, device=boxes.device)
    order, keep = nms_indices(boxes, scores, valid, iou_threshold)
    order, keep = order.cpu().numpy(), keep.cpu().numpy()
    return order[keep]


def batched_box_nmsi(boxes, scores, iou_threshold: float, batch_size: int = None, device=None):
    """NMS of each of several lists of boxes (the reference's
    ``cd.ops.batched_box_nmsi``): each list through :func:`nms_chunked`
    (``batch_size`` its chunk), on its tensors' device or, for other inputs,
    on ``device`` (``cuda`` by default); its kept indices returned as host
    numpy in stable descending score order."""
    import numpy as np
    assert len(boxes) == len(scores)
    out = []
    for b, s in zip(boxes, scores):
        b = _on_device(b, device)
        s = _on_device(s, device).to(b.device)
        v = torch.ones(b.shape[0], dtype=torch.bool, device=b.device)
        kw = {'chunk': int(batch_size)} if batch_size else {}
        keep = nms_chunked(b, s, v, iou_threshold, **kw)
        idx = np.flatnonzero(keep.cpu().numpy())
        out.append(idx[np.argsort(-s.cpu().numpy()[idx], kind='stable')])
    return out


def get_iou_voting(boxes: torch.Tensor, thresh: float, valid: torch.Tensor = None) -> torch.Tensor:
    """Sum of IoUs > thresh against all (valid) boxes, including self."""
    iou = box_iou(boxes, boxes)
    iou = iou * (iou > thresh)
    if valid is not None:
        iou = iou * valid[None, :]
    return iou.sum(-1)


def filter_by_box_voting(boxes: torch.Tensor, thresh: float, min_vote: float,
                         valid: torch.Tensor = None, return_votes: bool = False):
    """Keep mask of boxes whose IoU-vote sum reaches ``min_vote``.

    A box votes for itself (vote 1.0) and every box overlapping it with
    IoU > ``thresh`` adds its IoU to the vote.
    """
    votes = get_iou_voting(boxes, thresh, valid)
    mask = votes >= min_vote
    if valid is not None:
        mask = mask & valid
    if return_votes:
        return mask, votes
    return mask
