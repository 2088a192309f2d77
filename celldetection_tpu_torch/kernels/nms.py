"""Exact greedy NMS in hand-written Hopper kernels: ``csrc/nms_bits.cu``, ``csrc/nms_resolve.cu``.

Together they replace ``celldetection_tpu/kernels/nms_pallas.py:_nms_kernel``
(the only Pallas kernel of the JAX package; ``pallas_call`` at line 149). As
in the JAX package, the wrapper around the sweep (``ops/boxes.py:nms_padded``)
sorts by score, gathers the boxes and scatters the keep mask back to the
original order. :func:`nms_sweep` does the sweep over the sorted boxes in
three kernels, each with its own launch wrapper:

1. :func:`nms_bits_count`: each box's column word in its own block (the
   earlier boxes of its block that suppress it) and, for the packed layout,
   every pair test of every image across the whole card: how many of each
   row's later words are not 0, which pairs of blocks hold such a word, and
   each row's word of the next block;
2. :func:`nms_bits_fill`: the later words that are not 0, as (bits, row,
   word) pairs;
3. :func:`nms_resolve`: the greedy over the blocks in order, one CTA per
   image, with the image's removed bits in shared memory.

:func:`slots_layout` picks the layout and :func:`band_plan` the bands. An
image of at most ``SLOT_BLOCKS`` blocks (2048 boxes, the per-image main
path) takes the slots layout: every later word has a fixed slot, the count
does only the diagonal blocks and the fill every later test, so each test
runs once and neither a prefix sum nor the host is needed between the
kernels; at 2048 boxes, where the call is bound by the host, that makes it
faster than the packed layout (PERF.md). Larger images take the packed
layout: a ``torch.cumsum`` of the counts gives each row's offset and the
fill tests again only the flagged block pairs; where every later word of
every row would fit in ``PAIR_BUDGET`` (up to ~23,000 boxes in one image)
there is one band and that bound sizes the scratch, otherwise one read of
the counts on the host cuts the row blocks into bands of at most
``PAIR_BUDGET`` pairs, and the removed bits carry from one band to the next.
:func:`large_layout` marks images of more than ``LARGE_BLOCKS`` blocks
(262,144 boxes, the JAX package's largest exact NMS) up to ``MAX_BOXES``
(2^20): their block flags are bits, not bytes, and their resolve stages fewer
pairs a block, so that the removed bits of 2^20 boxes fit in shared memory.
The sources explain what bounds each kernel on this card and what its design
does about it.

:func:`bits_sweep` times its steps as spans (:mod:`..util.spans`):
``nms.count`` (the count kernel, the prefix sum and, with several bands, the
read of the offsets on the host), then ``nms.fill`` and ``nms.resolve`` a
band; each launch adds 1 to its span's ``launches`` and to
``build.LAUNCHES`` under its C entry's name (``'cdt_nms_bits_count'``,
``'cdt_nms_bits_fill'``, ``'cdt_nms_resolve'``).

The plain versions sit at the end of this module, with the same contracts:
``_suppression_counts``, ``_suppression_pairs`` and ``_resolve_blocks`` for
the kernels one by one, and ``_nms_sweep`` for the whole sweep. Each wrapper
runs its plain version for a CPU tensor and launches its kernel for a CUDA
tensor; there is no fallback from one to the other. :func:`nms_sweep` checks
the inputs (device, types, shapes, contiguity, sizes) once for all three; the
kernel wrappers take what it has checked. Two are ports of the JAX package's
``celldetection_tpu/ops/boxes.py``: ``_suppression_matrix`` (95-109), the
one rounding rule that the plain sweep, the kernels and the ranks' last
rounds of a stitch (``parallel/tiles.py``) share, and ``_nms_sweep``
(216-250), which runs on the CPU what :func:`nms_sweep` runs on the card.
"""
import ctypes
import functools

import torch

from ..util.spans import span
from .build import KernelLibrary, launch, load

__all__ = ['nms_sweep', 'bits_sweep', 'nms_bits_count', 'nms_bits_fill', 'nms_resolve',
           'bits_library', 'resolve_library', 'slots_layout', 'large_layout', 'band_plan',
           'pair_bands', 'PAIR_BUDGET', 'MAX_BOXES', 'SLOT_BLOCKS', 'LARGE_BLOCKS']

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
# Pairs of one band at most (16 bytes each: 128 MiB), unless one row block
# alone has more (B * 64 * (M / 64 - 1) pairs at most: 56 images of 16,384
# boxes give 0.9 M). With diag, the next words, the offsets and their copy
# (8 bytes per box each) and the flags (B * (M / 64)^2 bytes, an eighth of
# that in the large layout) this bounds the sweep's scratch; a band's pairs
# are freed before the next band's are made.
PAIR_BUDGET = 8 * 2 ** 20
# Blocks per image at most in the byte flags and the resolve's first variant:
# 262,144 boxes, the JAX package's largest exact NMS (ops/boxes.py:
# _PALLAS_NMS_MAX there), 16 MiB of flags and 200,704 bytes of shared memory.
LARGE_BLOCKS = 4096
# Boxes per image at most: 2^20, the large layout's 32 MiB of flags and its
# resolve's 200,704 bytes of shared memory (the removed bits take 128 KiB).
MAX_BOXES = 16384 * BLOCK
# Blocks per image at most for the slots layout: a block's 64 x 31 slots fit
# one stage of the resolve's ring in shared memory (2,048 pairs,
# csrc/nms_resolve.cu).
SLOT_BLOCKS = 32
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def bits_library() -> KernelLibrary:
    """Build (at first use) and load ``csrc/nms_bits.cu``."""
    return load('nms_bits.cu', {
        'cdt_nms_bits_count': [_P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _P],
        'cdt_nms_bits_fill': [_P, _P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _I,
                              ctypes.c_longlong, _I, _P]})


@functools.cache
def resolve_library(trace: bool = False) -> KernelLibrary:
    """Build (at first use) and load ``csrc/nms_resolve.cu``.

    Args:
        trace: the instrumented build, which also sums the clock cycles of
            each phase of the walk (``cdt_nms_resolve_phases``; read by
            ``scripts/torch_nms_resolve_steps.py``). The wrappers never use it.
    """
    functions = {
        'cdt_nms_resolve': [_P, _P, _P, _P, ctypes.c_longlong, _P, _P, _I, _I, _I, _I, _I, _P],
        'cdt_empty_launch': [_P]}
    if trace:
        functions['cdt_nms_resolve_phases'] = [_P]
    return load('nms_resolve.cu', functions, ('CDT_NMS_TRACE',) if trace else ())


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def nms_bits_count(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float,
                   packed: bool = True, large: bool = False):
    """Each box's column word in its own block and, for the packed layout,
    each row's number of non-zero later words, which block pairs hold one,
    and each row's word of the next block.

    Args:
        packed: ``False`` for the slots layout, which needs the column words only.
        large: the flags as bits (:func:`large_layout`).

    Returns:
        ``(start [nb * B * 64 + 1] int64, diag [B, nb * 64] int64, flags
        [B * nb * nb] uint8 (large: [B * nb * ceil(nb / 32)] int32 bits),
        nxt [B, nb * 64] int64)``; for slots all but ``diag`` are ``None``.
        ``start[1 + q]`` is the count of block-major row q, ``start[0] = 0``;
        see :func:`_suppression_counts`.
    """
    if boxes.device.type == 'cpu':
        start, diag, flags, nxt = _suppression_counts(boxes, valid, iou_threshold, large)
        return (start, diag, flags, nxt) if packed else (None, diag, None, None)
    bsz, m = valid.shape
    nb = -(-m // BLOCK)
    diag = torch.empty(bsz, nb * BLOCK, dtype=torch.int64, device=boxes.device)
    start = flags = nxt = None
    if packed:
        start = torch.empty(nb * bsz * BLOCK + 1, dtype=torch.int64, device=boxes.device)
        flags = (torch.empty(bsz * nb * -(-nb // 32), dtype=torch.int32, device=boxes.device)
                 if large else torch.empty(bsz * nb * nb, dtype=torch.uint8, device=boxes.device))
        nxt = torch.empty(bsz, nb * BLOCK, dtype=torch.int64, device=boxes.device)
    launch(bits_library(), 'cdt_nms_bits_count', boxes.device, boxes.data_ptr(),
           valid.data_ptr(), _ptr(start), diag.data_ptr(), _ptr(nxt), _ptr(flags), bsz, m,
           float(iou_threshold), int(large))
    return start, diag, flags, nxt


def nms_bits_fill(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float,
                  r0: int, r1: int, flags: torch.Tensor, start: torch.Tensor, base: int,
                  size: int, large: bool = False) -> torch.Tensor:
    """The non-zero later words of the rows in blocks ``[r0, r1)``.

    Args:
        flags: :func:`nms_bits_count`'s; only flagged block pairs are tested
            (packed; the slots layout tests every later block pair).
        start: the rows' offsets, the exclusive prefix sum of
            :func:`nms_bits_count`'s counts; ``base = start[r0 * B * 64]``.
            ``None``: the slots layout, for all row blocks at once.
        size: room for the band's pairs, at least ``start[r1 * B * 64] - base``;
            in the slots layout ``B * 64 * nb * (nb - 1) / 2``.
        large: as :func:`nms_bits_count`'s, which made ``flags``.

    Returns:
        ``[size, 2]`` int64 pairs ``(bits, row | word << 32)``; packed, row by
        row at ``start - base`` in no fixed order inside a row, the room past
        the band's last pair not written; in slots, each word at its slot and
        zeros elsewhere (see ``csrc/nms_common.cuh``). The plain version
        returns exactly the pairs, ordered by row and word.
    """
    if boxes.device.type == 'cpu':
        return _suppression_pairs(boxes, valid, iou_threshold, r0, r1)
    bsz, m = valid.shape
    cursor = None if start is None else start.clone()
    pairs = torch.empty(size, 2, dtype=torch.int64, device=boxes.device)
    launch(bits_library(), 'cdt_nms_bits_fill', boxes.device, boxes.data_ptr(),
           valid.data_ptr(), _ptr(flags), _ptr(cursor), pairs.data_ptr(), bsz, m,
           float(iou_threshold), r0, r1, base, int(large))
    return pairs


def nms_resolve(valid: torch.Tensor, diag: torch.Tensor, nxt: torch.Tensor,
                pairs: torch.Tensor, start: torch.Tensor, base: int, removed: torch.Tensor,
                keep: torch.Tensor, r0: int, r1: int, large: bool = False) -> None:
    """The greedy over row blocks ``[r0, r1)``; updates ``keep`` and ``removed`` in place.

    Args:
        diag, nxt: :func:`nms_bits_count`'s (``nxt`` ``None`` for slots).
        pairs, start, base: the band's pairs and the rows' offsets
            (:func:`nms_bits_fill`; ``start`` ``None`` for the slots layout).
        removed: ``[B, ceil(M / 64)]`` int64, the bits removed by kept boxes of
            earlier bands; read only where ``r0 > 0``, then written. ``None``
            where this band is the only one.
        keep: ``[B, M]`` bool; the band's rows are written.
        large: the variant for large images (:func:`large_layout`; packed).
    """
    if valid.device.type == 'cpu':
        return _resolve_blocks(valid, diag, pairs, removed, keep, r0, r1)
    bsz, m = valid.shape
    launch(resolve_library(), 'cdt_nms_resolve', valid.device,
           diag.data_ptr(), _ptr(nxt), pairs.data_ptr(), _ptr(start), base, _ptr(removed),
           keep.data_ptr(), bsz, m, r0, r1, int(large))


def pair_bands(cum_pairs, budget: int = PAIR_BUDGET):
    """Cut the row blocks into bands of at most ``budget`` pairs.

    Args:
        cum_pairs: inclusive running sum of each row block's pairs (all
            images together), one entry per block.

    Returns:
        ``[(r0, r1), ...]`` covering every block in order; a block with more
        than ``budget`` pairs is a band of its own.
    """
    bands, r0, base = [], 0, 0
    for r, total in enumerate(cum_pairs):
        if r > r0 and total - base > budget:
            bands.append((r0, r))
            r0, base = r, cum_pairs[r - 1]
    return bands + [(r0, len(cum_pairs))] if len(cum_pairs) else bands


def slots_layout(batch: int, m: int, pair_budget: int = PAIR_BUDGET) -> bool:
    """Whether :func:`bits_sweep` takes the slots layout for ``[batch, m]``
    boxes: at most ``SLOT_BLOCKS`` blocks per image, and every later word of
    every row within ``pair_budget``."""
    nb = -(-m // BLOCK)
    return nb <= SLOT_BLOCKS and batch * BLOCK * nb * (nb - 1) // 2 <= pair_budget


def large_layout(m: int) -> bool:
    """Whether images of ``m`` boxes take the large layout: more than
    ``LARGE_BLOCKS`` blocks (flags as bits; the resolve's variant with fewer
    pairs staged a block)."""
    return -(-m // BLOCK) > LARGE_BLOCKS


def band_plan(start, batch: int, m: int, pair_budget: int = PAIR_BUDGET):
    """The bands of row blocks that :func:`bits_sweep` walks.

    Args:
        start: ``None`` for the slots layout; for the packed layout the rows'
            offsets, the prefix sum of :func:`nms_bits_count`'s counts.

    Returns:
        ``[(r0, r1, base, size), ...]``: each band's row blocks, its first
        pair's offset and the room its pairs take. One band of room for every
        later word of every row, with no read on the host, in the slots layout
        and where that room fits ``pair_budget``; otherwise :func:`pair_bands`
        over the offsets read back, each band's room exact.
    """
    nb = -(-m // BLOCK)
    bound = batch * BLOCK * nb * (nb - 1) // 2     # every later word of every row
    if start is None or bound <= pair_budget:
        return [(0, nb, 0, bound)]
    ends = start[batch * BLOCK::batch * BLOCK].tolist()   # each row block's end offset
    return [(r0, r1, ends[r0 - 1] if r0 else 0, ends[r1 - 1] - (ends[r0 - 1] if r0 else 0))
            for r0, r1 in pair_bands(ends, pair_budget)]


def bits_sweep(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float,
               pair_budget: int = PAIR_BUDGET, large: bool = None) -> torch.Tensor:
    """The sweep of :func:`nms_sweep` through the three kernel wrappers.

    On CPU tensors it runs their plain versions, band by band as on the card.

    Args:
        large: the large layout; ``None``: :func:`large_layout` decides. It
            is packed, so it takes no slots.
    """
    bsz, m = valid.shape
    large = large_layout(m) if large is None else large
    slots = not large and slots_layout(bsz, m, pair_budget)
    with span('nms.count'):
        start, diag, flags, nxt = nms_bits_count(boxes, valid, iou_threshold, packed=not slots,
                                                 large=large)
        if start is not None:
            start.cumsum_(0)                       # start[0] is 0: the rows' offsets
        bands = band_plan(start, bsz, m, pair_budget)
    keep = torch.empty_like(valid)
    removed = (torch.empty(bsz, -(-m // BLOCK), dtype=torch.int64, device=boxes.device)
               if len(bands) > 1 else None)
    for r0, r1, base, size in bands:
        with span('nms.fill'):
            pairs = nms_bits_fill(boxes, valid, iou_threshold, r0, r1, flags, start, base, size,
                                  large)
        with span('nms.resolve'):
            nms_resolve(valid, diag, nxt, pairs, start, base, removed, keep, r0, r1, large)
        del pairs                                  # before the next band's are made
    return keep


def nms_sweep(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy NMS keep mask over score-sorted boxes.

    Args:
        boxes: ``[B, M, 4]`` float32, each image sorted by descending score.
        valid: ``[B, M]`` bool.
        iou_threshold: Suppression threshold (strictly greater).

    Returns:
        ``[B, M]`` bool keep mask in the given (sorted) order.
    """
    if boxes.device.type == 'cpu':
        return _nms_sweep(boxes, valid, iou_threshold)
    if boxes.device.type != 'cuda':
        raise ValueError(f'nms_sweep: no kernel for device {boxes.device}')
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f'nms_sweep takes float32 boxes and bool valid, got '
                        f'{boxes.dtype} and {valid.dtype}')
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or valid.shape != boxes.shape[:2]:
        raise ValueError(f'nms_sweep: boxes {tuple(boxes.shape)} and valid '
                         f'{tuple(valid.shape)} are not [B, M, 4] and [B, M]')
    if valid.device != boxes.device:
        raise ValueError('nms_sweep: boxes and valid lie on different devices')
    if not (boxes.is_contiguous() and valid.is_contiguous()) or boxes.data_ptr() % 16:
        raise ValueError('nms_sweep: inputs must be contiguous, boxes 16-byte aligned')
    bsz, m = valid.shape
    if bsz * m >= 2 ** 31 or m > MAX_BOXES or bsz > 65_535:
        raise ValueError(f'nms_sweep: {bsz} x {m} boxes exceed the kernels\' limits '
                         f'(B * M < 2^31, M <= {MAX_BOXES}, B <= 65,535)')
    if valid.numel() == 0:
        return torch.empty_like(valid)
    return bits_sweep(boxes, valid, iou_threshold)


# -- the plain versions: the matrix they all round by, the whole sweep, each kernel


def _suppression_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor, thresh: float) -> torch.Tensor:
    """``IoU > thresh`` as ``inter > thresh * union``, ``[..., n, m]`` bool.

    The multiply form with ``union = (area1 + area2) - inter``, in that order,
    is the one the JAX sweep, the Pallas kernel and the CUDA kernel all use,
    so all of them round identically on knife-edge IoUs.
    """
    area1 = (boxes1[..., 2] - boxes1[..., 0]) * (boxes1[..., 3] - boxes1[..., 1])
    area2 = (boxes2[..., 2] - boxes2[..., 0]) * (boxes2[..., 3] - boxes2[..., 1])
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
