"""Tiled gigapixel inference, on one card or split over ranks.

Counterpart of ``celldetection_tpu/parallel/tiles.py``: ``tile_image``
(36-65), ``_border_filter`` and ``_stitch_filter`` (68-93),
``stitch_detections``, ``stitch_flat`` and ``compact_detections``
(96-190), ``tta_inference`` (193-252), ``multihost_tiled_inference``
(255-340) and ``TiledInference`` (343-704, its ``mesh`` at 358-389).

  1. The host cuts the mosaic into fixed-size tiles (edge tiles are
     stop-anchored, so every tile has the same shape).
  2. Batches of tiles run the CPN forward with each tile's offset added in
     the decode, so detections come out in global coordinates.
  3. The border filter (interior tile borders only), the optional stitching
     rule and the minimum box size are masks on the device.
  4. All capacity-padded per-tile detections are flattened into one set and
     one greedy NMS (``ops/boxes.py: nms_chunked``, the hand-written kernels
     on a card) removes the duplicates of the tile overlaps.

Per-tile results stay on the device; the host reads the per-tile overflow
flags, a few counts, and the kept detections of the compacted set.

Over several ranks (:func:`multihost_tiled_inference`), each rank runs
steps 1-4 on its share of the tiles and the ranks then exchange their kept
detections and repeat one NMS over them, so that every rank holds the same
result.
"""
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.nms import _suppression_matrix
from ..ops.boxes import nms_chunked, nms_padded, remove_small_boxes_mask
from ..util.spans import count, span
from ..util.tiling import get_tiling_slices
from .mesh import host_group, mesh_group

__all__ = ['TiledInference', 'tile_image', 'stitch_detections', 'stitch_flat',
           'compact_detections', 'tta_inference', 'multihost_tiled_inference']

KEYS = ('contours', 'boxes', 'scores', 'classes', 'locations', 'fourier')


def tile_image(image: np.ndarray, tile_size: int, stride: int):
    """Slice a mosaic into fixed-shape tiles.

    Returns:
        ``(tiles [T, ts, ts, C], offsets [T, 2] (x, y) float32, borders [T, 4]
        bool (top, right, bottom, left: the side is interior), overlaps
        [T, 2, 2] float32, shape)``.
    """
    if image.ndim == 2:
        image = image[..., None]
    h, w, c = image.shape
    ts = tile_size
    pad_h, pad_w = max(0, ts - h), max(0, ts - w)
    if pad_h or pad_w:
        image = np.pad(image, ((0, pad_h), (0, pad_w), (0, 0)))
        h, w = image.shape[:2]
    slices, overlaps, shape = get_tiling_slices((h, w), ts, stride, return_overlaps=True)
    tiles, offs, borders, ovs = [], [], [], []
    for sl, ov in zip(slices, overlaps):
        sy, sx = sl
        tiles.append(image[sy, sx])
        offs.append((sx.start, sy.start))
        # a side needs the border filter iff it does not touch the mosaic's edge
        borders.append((sy.start != 0, sx.stop != w, sy.stop != h, sx.start != 0))
        ovs.append(ov)
    return (np.stack(tiles), np.asarray(offs, np.float32), np.asarray(borders, bool),
            np.asarray(ovs, np.float32), shape)


def _border_filter(contours, offsets, borders, tile_size, padding):
    """Keep mask ``[T, K]`` of global ``[T, K, S, 2]`` contours: a contour is
    dropped where it reaches into a border region, ``padding`` px wide, of an
    interior side of its tile (``borders [T, 4]``).

    The local coordinates are the global ones less the offset, in fp32, as in
    the JAX package: computed directly they would round otherwise, and a
    contour on the margin could flip.
    """
    local = contours - offsets[:, None, None, :]
    x, y = local[..., 0], local[..., 1]
    h = w = tile_size
    viol_top = (y <= padding).any(-1)
    viol_right = (x >= (w - padding)).any(-1)
    viol_bottom = (y >= (h - padding)).any(-1)
    viol_left = (x <= padding).any(-1)
    viol = ((viol_top & borders[:, None, 0]) | (viol_right & borders[:, None, 1])
            | (viol_bottom & borders[:, None, 2]) | (viol_left & borders[:, None, 3]))
    return ~viol


def _stitch_filter(contours, offsets, overlaps, tile_size):
    """The 'ex_br' stitching rule over tiles: drop contours that lie wholly in
    a tile's exclusive bottom or right overlap (global coordinates in)."""
    local = contours - offsets[:, None, None, :]
    stop = (tile_size - overlaps[:, :, 1]).flip(-1)            # [T, 2] (x, y)
    return ~(local >= stop[:, None, None, :]).any(-1).all(-1)


def _by_score(valid: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """Stable descending order of ``where(valid, scores, -inf)``: ties keep the lower index first."""
    return torch.sort(torch.where(valid, scores, -torch.inf), descending=True,
                      stable=True).indices


def stitch_detections(det: dict, nms_thresh: float, nms_tile: int = 256,
                      max_candidates: Optional[int] = None, nms_chunk: int = 16384,
                      survivors_cap=None, trace: list = None) -> dict:
    """Cross-tile de-duplication: flatten ``[T, K, ...]`` detections and run
    :func:`stitch_flat` over them."""
    t, k = det['valid'].shape
    flat = {key: None if det.get(key) is None else det[key].reshape((t * k,) + det[key].shape[2:])
            for key in KEYS + ('valid',)}
    return stitch_flat(flat, nms_thresh, nms_tile=nms_tile, max_candidates=max_candidates,
                       nms_chunk=nms_chunk, survivors_cap=survivors_cap, trace=trace)


def stitch_flat(flat: dict, nms_thresh: float, nms_tile: int = 256,
                max_candidates: Optional[int] = None, nms_chunk: int = 16384,
                survivors_cap=None, trace: list = None) -> dict:
    """Cross-tile NMS on a flat ``[N]`` candidate dict.

    Above ``max_candidates`` rows the candidates are first compacted to the
    best ``max_candidates`` by (valid, score). Then :func:`..ops.boxes.
    nms_chunked` (exact up to 262,144 rows, chunked above); ``survivors_cap=
    'full'`` sizes its cross-chunk pass to all candidates.

    Returns:
        The dict with ``valid`` replaced by the keep mask, beside
        ``candidates`` (the swept rows' validity), ``num_pre_valid`` (the
        valid count before the compaction, a tensor) and
        ``survivors_overflow`` (a bool: the cross-chunk pass dropped
        survivors).
    """
    flat = dict(flat)
    n = flat['valid'].shape[0]
    flat['num_pre_valid'] = flat['valid'].sum()
    if max_candidates is not None and n > max_candidates:
        order = _by_score(flat['valid'], flat['scores'])[:max_candidates]
        for key in KEYS + ('valid', 'order'):
            if flat.get(key) is not None:
                flat[key] = flat[key][order]
        n = max_candidates
    if survivors_cap == 'full':
        survivors_cap = n
    flat['candidates'] = flat['valid']
    flat['valid'], flat['survivors_overflow'] = nms_chunked(
        flat['boxes'], flat['scores'], flat['valid'], nms_thresh, chunk=nms_chunk, tile=nms_tile,
        survivors_cap=survivors_cap, return_overflow=True, trace=trace)
    return flat


def compact_detections(flat: dict, max_outputs: int) -> dict:
    """The kept detections gathered into a ``[max_outputs]`` buffer, sorted by
    score (stable), padded with ``valid=False`` rows; ``num_valid`` is the
    keep count before the cut (a tensor)."""
    n = flat['valid'].shape[0]
    order = _by_score(flat['valid'], flat['scores'])[:max_outputs]
    pad = max_outputs - order.shape[0]
    if pad > 0:
        order = torch.cat([order, order.new_zeros(pad)])
    row_valid = torch.arange(max_outputs, device=order.device) < n
    out = {key: None if flat.get(key) is None else flat[key][order] for key in KEYS + ('order',)}
    out['valid'] = flat['valid'][order] & row_valid
    out['num_valid'] = flat['valid'].sum()
    return out


def _concat(chunks):
    return {k: None if chunks[0][k] is None else torch.cat([c[k] for c in chunks])
            for k in chunks[0]}


class TiledInference:
    """Sliding-window CPN inference over arbitrarily large mosaics, on the model's device.

    Args:
        model: A :class:`..models.cpn.CPN`.
        tile_size / stride: Window geometry (the reference CLI's 1024 / 768).
        batch_size: Tiles per forward (default 1); halved on a CUDA
            out-of-memory error, down to 1.
        border_removal: Interior-border margin in px.
        stitching_rule: ``'nms'``, optionally ``+ ',ex_br'``.
        max_outputs / max_candidates / nms_chunk / nms_tile: The stitch's
            caps, as in the JAX package; with ``retry_overflow`` saturated
            caps grow and the survivor pass is re-run at ``'full'``.
        max_capacity_factor: Tiles with more foreground pixels than the
            capacity re-run at 2x, 4x, ... this many times it.
        mesh: Optional ``DeviceMesh`` (or process group) of ranks, one card
            each. The JAX package's mesh shards a batch of tiles over the
            chips of one program; with one card per process the port reads
            a mesh as ranks instead: a mesh of several ranks sends every call
            through :func:`multihost_tiled_inference`, which splits the
            mosaic's tiles over them (every rank calls with the same image).

    After a call, ``stats`` holds the host ms of its stages, each the ``.ms``
    of its span (:mod:`..util.spans`) and each ended by a device
    synchronisation the pipeline makes anyway: ``forward_ms``
    (``tiled.forwards``), ``retry_ms`` (``tiled.retry``, with the flattening
    of the candidates), ``stitch_ms`` (``tiled.stitch``: compaction and NMS
    of every attempt), ``readback_ms`` (``tiled.readback``), ``total_ms``
    (``tiled.call``, the outer span of a call); ``nms``, each NMS pass of the
    stitch (name, ``B x M``, ms of its span ``nms.<name>``, kernel launches)
    and the survivor counts; ``num_tiles``, ``attempts`` and
    ``retried_tiles``. The host's tiling and mask crops are the span
    ``tiled.tile_image`` (counts ``tiles_cut``, ``tiles_kept``), the input
    and geometry copies ``tiled.prepare_inputs`` (``bytes``); both are in
    ``total_ms`` and have no key of their own.
    """

    def __init__(self, model, tile_size: int = 1024, stride: int = 768,
                 batch_size: Optional[int] = None, border_removal: int = 4,
                 stitching_rule: str = 'nms', nms_tile: int = 256, max_outputs: int = 100_000,
                 max_candidates: Optional[int] = None, nms_chunk: int = 16384,
                 retry_overflow: bool = True, max_capacity_factor: int = 8, mesh=None):
        self.model = model
        self.mesh = mesh
        self.tile_size = tile_size
        self.stride = stride
        self.batch_size = batch_size or 1
        self.border_removal = border_removal
        self.stitching_rule = stitching_rule
        self.nms_tile = nms_tile
        self.max_outputs = max_outputs
        self.max_candidates = max_candidates or 4 * max_outputs
        self.nms_chunk = nms_chunk
        self.retry_overflow = retry_overflow
        self.max_capacity_factor = max_capacity_factor
        self.stats = {}

    def _tile_forward(self, tiles, offsets, borders, overlaps, score_thresh, lower, upper,
                      capacity: int) -> dict:
        out = self.model.forward_padded(tiles, score_thresh=score_thresh, nms=False,
                                        offsets=offsets, scores_lower_bound=lower,
                                        scores_upper_bound=upper, max_detections=capacity)
        valid = out['valid'] & _border_filter(out['contours'], offsets, borders, self.tile_size,
                                              self.border_removal)
        if 'ex_br' in self.stitching_rule.split(','):
            valid &= _stitch_filter(out['contours'], offsets, overlaps, self.tile_size)
        valid &= remove_small_boxes_mask(out['boxes'], 1.)   # forward_tiled's remove_small_boxes
        res = {k: out[k] for k in KEYS}
        res['valid'] = valid
        res['fg_overflow'] = out['fg_count'] > capacity       # drives the capacity retry
        return res

    def _run_batches(self, tiles, offsets, borders, overlaps, score_thresh, upper_tiles,
                     lower_tiles, use_bounds: bool, capacity: int):
        """Per-batch forwards of device tiles; the last batch is padded to the
        batch size with empty tiles, whose rows are cut off again."""
        bs, t, dev = self.batch_size, tiles.shape[0], tiles.device
        chunks = []
        for i in range(math.ceil(t / bs)):
            sl = slice(i * bs, (i + 1) * bs)
            tb, ob, bb, vb = tiles[sl], offsets[sl], borders[sl], overlaps[sl]
            n = tb.shape[0]
            ub = None if upper_tiles is None else upper_tiles[sl]
            lb = None if lower_tiles is None else lower_tiles[sl]
            if n < bs:
                reps = bs - n
                tb = torch.cat([tb, tb.new_zeros((reps,) + tb.shape[1:])])
                ob = torch.cat([ob, ob.new_zeros(reps, 2)])
                bb = torch.cat([bb, bb.new_ones(reps, 4)])
                vb = torch.cat([vb, vb.new_zeros(reps, 2, 2)])
                ub = None if ub is None else np.concatenate([ub, np.zeros((reps,) + ub.shape[1:],
                                                                          ub.dtype)])
                lb = None if lb is None else np.concatenate([lb, np.zeros((reps,) + lb.shape[1:],
                                                                          lb.dtype)])
            if use_bounds:   # as in the JAX package: a missing bound is all ones or zeros
                bound_shape = tb.shape[:3] + (1,)
                ub = (torch.ones(bound_shape, device=dev) if ub is None
                      else torch.from_numpy(ub).to(dev))
                lb = (torch.zeros(bound_shape, device=dev) if lb is None
                      else torch.from_numpy(lb).to(dev))
            out = self._tile_forward(tb, ob, bb, vb, score_thresh, lb, ub, capacity)
            if n < bs:
                out = {k: None if v is None else v[:n] for k, v in out.items()}
            chunks.append(out)
        return chunks

    def candidates(self, image: np.ndarray, score_thresh: Optional[float] = None,
                   mask: Optional[np.ndarray] = None, point_mask: Optional[np.ndarray] = None,
                   point_mask_exclusive: bool = False, part=None):
        """The flat candidates that the stitch de-duplicates: every tile's
        capacity-padded rows, retried tiles' wider rows after the others in
        tile order (the flat order decides score ties), on the device.

        ``part=(r, p)`` keeps the tiles ``r, r + p, ...`` of those the masks
        leave (rank ``r``'s share of ``p``). ``flat['order']`` is each row's
        place in the flat order of all those tiles' rows, which decides score
        ties in the stitch, whatever the part.

        Returns:
            ``(flat, num_tiles, residual_fg_overflow)``; ``flat`` is ``None``
            where every tile was skipped. Arguments as :meth:`__call__`'s.
        """
        model = self.model
        dev = model.device
        with span('tiled.tile_image'):
            tiles, offsets, borders, overlaps, _ = tile_image(np.asarray(image), self.tile_size,
                                                              self.stride)
            count('tiles_cut', tiles.shape[0])
            use_bounds = mask is not None or point_mask is not None
            upper_tiles = lower_tiles = None
            if use_bounds:
                def crop_tiles(m):
                    if m is None:
                        return None
                    return tile_image(np.asarray(m, np.float32), self.tile_size,
                                      self.stride)[0][..., :1]

                mask_tiles, lower_tiles = crop_tiles(mask), crop_tiles(point_mask)
                upper_tiles = mask_tiles
                if point_mask_exclusive and lower_tiles is not None:
                    upper_tiles = lower_tiles          # the points replace the upper bound
                # a tile is skipped where its crop of the mask or of the point mask is empty
                nonempty = None
                for src in (mask_tiles, lower_tiles):
                    if src is not None:
                        ne = src.reshape(src.shape[0], -1).max(-1) > 0
                        nonempty = ne if nonempty is None else nonempty & ne
                tiles, offsets, borders, overlaps = (a[nonempty] for a in
                                                     (tiles, offsets, borders, overlaps))
                upper_tiles = None if upper_tiles is None else upper_tiles[nonempty]
                lower_tiles = None if lower_tiles is None else lower_tiles[nonempty]
            total, tile_ids = tiles.shape[0], np.arange(tiles.shape[0])
            if part is not None:
                sel = tile_ids = np.arange(part[0], tiles.shape[0], part[1])
                tiles, offsets, borders, overlaps = (a[sel] for a in
                                                     (tiles, offsets, borders, overlaps))
                upper_tiles = None if upper_tiles is None else upper_tiles[sel]
                lower_tiles = None if lower_tiles is None else lower_tiles[sel]
            t = tiles.shape[0]
            count('tiles_kept', t)
        stats = self.stats = dict(num_tiles=t, nms=[], retried_tiles=0, attempts=0)
        if t == 0:
            return None, 0, False
        with span('tiled.prepare_inputs'):
            count('bytes', sum(a.nbytes for a in (tiles, offsets, borders, overlaps)))
            tiles = model.prepare_inputs(tiles)
            offsets, borders, overlaps = (torch.from_numpy(a).to(dev)
                                          for a in (offsets, borders, overlaps))
        st = model.score_thresh if score_thresh is None else score_thresh
        capacity = model.max_detections

        with span('tiled.forwards') as sp:
            while True:
                try:
                    det = _concat(self._run_batches(tiles, offsets, borders, overlaps, st,
                                                    upper_tiles, lower_tiles, use_bounds,
                                                    capacity))
                    break
                except torch.cuda.OutOfMemoryError:
                    if self.batch_size <= 1:
                        raise
                    self.batch_size //= 2
            fg_ovf = det['fg_overflow'].cpu().numpy()
        stats['forward_ms'] = sp.ms

        # per-tile capacity retry: saturated tiles re-run at 2x, 4x, ...
        with span('tiled.retry') as sp:
            retried = {}
            active = np.nonzero(fg_ovf)[0] if self.retry_overflow else np.zeros(0, np.int64)
            factor = 2
            while len(active) and factor <= self.max_capacity_factor:
                idx = torch.from_numpy(active).to(dev)
                hi = _concat(self._run_batches(
                    tiles[idx], offsets[idx], borders[idx], overlaps[idx], st,
                    None if upper_tiles is None else upper_tiles[active],
                    None if lower_tiles is None else lower_tiles[active], use_bounds,
                    capacity * factor))
                for j, tile_idx in enumerate(active):
                    retried[int(tile_idx)] = {k: None if v is None else v[j] for k, v in hi.items()}
                active = active[hi['fg_overflow'].cpu().numpy()]
                factor *= 2
            residual_fg_overflow = bool(len(active)) if self.retry_overflow else bool(fg_ovf.any())
            # a row's place among all tiles' rows: tile by tile, and the retried
            # tiles' rows after every other tile's
            ids = torch.from_numpy(tile_ids).to(dev)
            det['order'] = ids[:, None] * capacity + torch.arange(capacity, device=dev)
            for i, r in retried.items():
                r['order'] = (total + int(tile_ids[i]) * self.max_capacity_factor) * capacity + \
                    torch.arange(r['valid'].shape[0], device=dev)
            if retried:
                keep = torch.ones(t, dtype=torch.bool, device=dev)
                keep[list(retried)] = False
                flat = {k: None if det[k] is None else
                        torch.cat([det[k][keep].flatten(0, 1)]
                                  + [retried[i][k] for i in sorted(retried)])
                        for k in KEYS + ('valid', 'order')}
            else:
                flat = {k: None if det[k] is None else det[k].flatten(0, 1)
                        for k in KEYS + ('valid', 'order')}
            count('retried_tiles', len(retried))
        stats['retry_ms'] = sp.ms
        stats['retried_tiles'] = len(retried)
        return flat, t, residual_fg_overflow

    def __call__(self, image: np.ndarray, score_thresh: Optional[float] = None,
                 mask: Optional[np.ndarray] = None, point_mask: Optional[np.ndarray] = None,
                 point_mask_exclusive: bool = False) -> dict:
        """Run tiled inference; returns ragged numpy results in global coordinates.

        Args:
            mask: Optional foreground mask: scores are bounded above by it,
                and tiles whose crop of it is empty are skipped.
            point_mask: Optional prompt mask: scores are bounded below by it.
            point_mask_exclusive: Detect only at marked points: the point mask
                also becomes the upper bound, and tiles without a point are
                skipped.

        Returns:
            ``contours, boxes, scores, classes, locations, fourier`` of the
            kept detections, ``num_tiles``, ``num_valid`` and ``overflow``.
        """
        if mesh_group(self.mesh) is not None and dist.get_world_size(mesh_group(self.mesh)) > 1:
            return multihost_tiled_inference(self, image, score_thresh, mask, point_mask,
                                             point_mask_exclusive)
        with span('tiled.call') as call:
            flat, t, residual_fg_overflow = self.candidates(image, score_thresh, mask, point_mask,
                                                            point_mask_exclusive)
            stats = self.stats
            if flat is None:
                return self._empty_result()
            compact, num_valid, overflow, _ = self._stitch(flat)
            with span('tiled.readback') as sp:
                valid = compact['valid']
                result = {k: None if compact[k] is None else compact[k][valid].cpu().numpy()
                          for k in KEYS}
            stats['readback_ms'] = sp.ms
        stats['total_ms'] = call.ms
        result['num_tiles'] = t
        result['num_valid'] = num_valid
        result['overflow'] = bool(residual_fg_overflow or overflow)
        return result

    def _empty_result(self) -> dict:
        model = self.model
        empty = {k: np.zeros((0,) + s, np.float32) for k, s in
                 dict(contours=(model.samples, 2), boxes=(4,), scores=(), classes=(),
                      locations=(2,), fourier=(model.order, 4)).items()}
        empty.update(num_tiles=0, num_valid=0, overflow=False)
        return empty

    def _stitch(self, flat: dict):
        """The cross-tile stitch of ``flat`` candidates, its caps doubled on
        saturation (``retry_overflow``). Returns ``(compact, num_valid,
        overflow, stitched)``: the :func:`compact_detections` buffer, the keep
        count before its cut, whether a cap dropped detections in the end,
        and the last :func:`stitch_flat` result."""
        stats = self.stats
        max_out, max_cand, surv_cap = self.max_outputs, self.max_candidates, None
        with span('tiled.stitch') as sp:
            for attempt in range(4 if self.retry_overflow else 1):
                stitched = stitch_flat(flat, self.model.nms_thresh, nms_tile=self.nms_tile,
                                       max_candidates=max_cand, nms_chunk=self.nms_chunk,
                                       survivors_cap=surv_cap, trace=stats['nms'])
                compact = compact_detections(stitched, max_out)
                num_valid, num_pre = int(compact['num_valid']), int(stitched['num_pre_valid'])
                ovf_surv = stitched['survivors_overflow']
                ovf_out, ovf_cand = num_valid > max_out, num_pre > max_cand
                stats['attempts'] = attempt + 1
                if not self.retry_overflow or not (ovf_out or ovf_cand or ovf_surv):
                    break
                # num_pre is the candidate count before the cut and num_valid the
                # keep count of this candidate set: jump to power-of-two caps that
                # hold them; the output cap grows only past the keep count
                need_cand = num_pre if ovf_cand else 0
                while max_cand < need_cand:
                    max_cand *= 2
                while max_out < min(max(num_valid, 1), max_cand):
                    max_out *= 2
                if ovf_surv:
                    surv_cap = 'full'       # no survivor can be dropped on the retry
            count('attempts', stats['attempts'])
        stats['stitch_ms'] = sp.ms
        return compact, num_valid, bool(ovf_out or ovf_cand or ovf_surv), stitched


def _pack(compact: dict, rows: int) -> torch.Tensor:
    """The first ``rows`` rows of a compacted buffer as one float32 matrix:
    ``KEYS`` side by side (classes, small integers, are exact in float32),
    then the flat order in two columns of 20 bits and the rest."""
    order = compact['order'][:rows, None]
    return torch.cat([compact[k][:rows].reshape(rows, -1).float() for k in KEYS]
                     + [(order >> 20).float(), (order & 0xfffff).float()], 1)


def _pack_width(model) -> int:
    return 2 * model.samples + 4 + 1 + 1 + 2 + 4 * model.order + 2


def _unpack(packed: torch.Tensor, model) -> dict:
    widths = dict(contours=(model.samples, 2), boxes=(4,), scores=(), classes=(),
                  locations=(2,), fourier=(model.order, 4))
    out, col = {}, 0
    for k in KEYS:
        w = int(np.prod(widths[k]))
        out[k] = packed[:, col:col + w].reshape((-1,) + widths[k]).contiguous()
        col += w
    out['classes'] = out['classes'].to(torch.int32)
    out['order'] = (packed[:, col].long() << 20) + packed[:, col + 1].long()
    return out


def _exchange(local: torch.Tensor, group, extra=(), stats: dict = None):
    """Every rank's rows ``local [n_r, F]`` concatenated in rank order, on
    every rank: the counts (and the ints of ``extra``) first, through the
    host group, then the rows padded to the largest count in one
    ``all_gather`` on the device. The span ``ranks.exchange`` (counts
    ``rows``, ``bytes``: what this rank received) times it, waits for the
    slowest rank included; its ms are added to ``stats['exchange_ms']``
    where ``stats`` is given. Returns ``(rows, info [world, 1 + len(extra)],
    bytes received)``."""
    p = dist.get_world_size(group)
    with span('ranks.exchange') as sp:
        info = [torch.zeros(1 + len(extra), dtype=torch.int64) for _ in range(p)]
        dist.all_gather(info, torch.tensor([local.shape[0], *extra]), group=host_group(group))
        info = torch.stack(info)
        counts = info[:, 0].tolist()
        m = max(counts)
        rows, nbytes = local, 0
        if m:
            local = torch.cat([local, local.new_zeros((m - local.shape[0], local.shape[1]))])
            parts = [torch.empty_like(local) for _ in range(p)]
            dist.all_gather(parts, local, group=group)
            rows = torch.cat([part[:c] for part, c in zip(parts, counts)])
            nbytes = p * local.numel() * 4
        count('rows', rows.shape[0])
        count('bytes', nbytes)
    if stats is not None:
        stats['exchange_ms'] = stats.get('exchange_ms', 0.) + sp.ms
    return rows, info, nbytes


def _suppressor(boxes, scores, kept_boxes, kept_scores, thresh) -> torch.Tensor:
    """For each row of ``boxes``, the index of a kept box of a higher score
    that suppresses it (``inter > thresh * union``, as the NMS kernels
    test), or -1."""
    out = torch.full((boxes.shape[0],), -1, dtype=torch.int64, device=boxes.device)
    step = max(1, 2 ** 23 // max(kept_boxes.shape[0], 1))
    for i in range(0, boxes.shape[0], step):
        sup = _suppression_matrix(kept_boxes, boxes[i:i + step], thresh)
        sup &= kept_scores[:, None] > scores[None, i:i + step]
        out[i:i + step] = torch.where(sup.any(0), sup.to(torch.uint8).argmax(0), -1)
    return out


def _final_rounds(tiled: TiledInference, cat: torch.Tensor, pool: torch.Tensor, group):
    """The final NMS over the ranks' kept rows ``cat`` (the same on every
    rank), run again with the rows of each rank's ``pool`` (its local
    stitch's suppressed rows, packed) that no kept row of a higher score
    suppresses, until there are none. Returns ``(det, keep, survivors
    overflow, bytes received)``.

    The span ``ranks.final_rounds`` (counts ``rounds``, ``restored``) times
    it; the exchanges of the restored rows are ``ranks.exchange`` spans
    inside it. ``tiled.stats`` gets ``final_nms`` (the NMS passes),
    ``rounds``, ``restored`` (the final NMS's runs, and the suppressed rows
    that rejoined), ``final_nms_ms`` (the span's ms less its exchanges') and
    the exchanges' ms added to ``exchange_ms``."""
    stats = tiled.stats
    stats.update(final_nms=[], rounds=0, restored=0)
    exchanged = stats.setdefault('exchange_ms', 0.)
    with span('ranks.final_rounds') as sp:
        out = _rounds(tiled, cat, pool, group)
        count('rounds', stats['rounds'])
        count('restored', stats['restored'])
    stats['final_nms_ms'] = sp.ms - (stats['exchange_ms'] - exchanged)
    return out


def _rounds(tiled: TiledInference, cat: torch.Tensor, pool: torch.Tensor, group):
    model, stats = tiled.model, tiled.stats
    s2 = 2 * model.samples
    received = 0
    # the flat order of a kept row that suppresses each pool row (-1: none
    # known): a row stays suppressed while that row stays kept
    by = torch.full((pool.shape[0],), -1, dtype=torch.int64, device=pool.device)
    while True:
        # in the one-process flat order: score ties resolve as they do there
        cat = cat[torch.argsort(_unpack(cat, model)['order'], stable=True)]
        det = _unpack(cat, model)
        n = cat.shape[0]
        valid = torch.ones(n, dtype=torch.bool, device=cat.device)
        keep, surv_ovf = valid, False
        for cap in ((None, n) if tiled.retry_overflow else (None,)) if n else ():
            # nms_padded up to nms_chunk rows (and exactly up to EXACT_NMS_MAX),
            # chunked above; a dropped survivor re-runs the cross-chunk pass whole
            keep, surv_ovf = nms_chunked(det['boxes'], det['scores'], valid, model.nms_thresh,
                                         chunk=tiled.nms_chunk, tile=tiled.nms_tile,
                                         survivors_cap=cap, return_overflow=True,
                                         trace=stats['final_nms'])
            if not surv_ovf:
                break
        stats['rounds'] += 1
        kept_order = det['order'][keep]
        test = ~torch.isin(by, kept_order)
        rows = pool[test]
        sup = _suppressor(rows[:, s2:s2 + 4], rows[:, s2 + 4], det['boxes'][keep],
                          det['scores'][keep], model.nms_thresh)
        picked = kept_order[sup.clamp(min=0)] if len(kept_order) else sup
        by[test] = torch.where(sup >= 0, picked, -1)
        free = by < 0
        back, _, nbytes = _exchange(pool[free], group, stats=stats)
        received += nbytes
        pool, by = pool[~free], by[~free]
        if not back.shape[0]:
            return det, keep, surv_ovf, received
        stats['restored'] += back.shape[0]
        cat = torch.cat([cat, back])


def multihost_tiled_inference(tiled: TiledInference, image: np.ndarray,
                              score_thresh: Optional[float] = None,
                              mask: Optional[np.ndarray] = None,
                              point_mask: Optional[np.ndarray] = None,
                              point_mask_exclusive: bool = False, group=None) -> dict:
    """Split one mosaic's tiles over the ranks; every rank gets the same result.

    Every rank calls it with the same image. Tiles go round robin to the
    ranks (of those the masks leave); each rank runs its tiles' forwards (with
    the capacity retry), then :func:`stitch_flat` and
    :func:`compact_detections` on its own candidates, as :class:`TiledInference`
    does for a whole mosaic. The ranks exchange their kept rows (the counts,
    then the rows padded to the largest count, in one ``all_gather`` on the
    device), and every rank runs the same final NMS over their union
    (``nms_chunked`` above ``nms_chunk`` rows, else ``nms_padded``): the
    result is replicated rather than gathered to rank 0. A rank with no tile
    contributes no row. The rows carry their place in the one-process flat
    order (``candidates``), and the union is sorted by it, so that score
    ties resolve as in one process: overlapping tiles at strides of 32 px
    give a cell bit-equal scores from both tiles.

    Greedy NMS does not split over ranks: a row that its own rank's stitch
    suppressed survives the single stitch where every suppressor of it is
    suppressed in turn by another rank's row. So each rank then looks among
    its suppressed rows for those that no kept row of a higher score
    suppresses; they join the union and the final NMS runs again, until no
    rank has one. Where both take the exact NMS (up to ``EXACT_NMS_MAX``
    rows), the result is the single-process stitch's (proof: every row
    outside the union is suppressed by a kept row above it, so the greedy
    pass over all rows keeps what it keeps over the union). The JAX package
    stops after the first final NMS, and runs it over fixed ``[max_outputs]``
    buffers, padding included; the port's result does not depend on the
    number of ranks, and neither the exchange's padding nor ``max_outputs``
    decides between the exact and the chunked NMS.

    Args:
        tiled: The :class:`TiledInference` whose model, geometry and caps
            every rank uses.
        group: The process group; the mesh's of ``tiled`` (or the default
            group) when None.

    Returns:
        As :meth:`TiledInference.__call__`: the kept detections by
        descending score, ``num_tiles`` (over every rank), ``num_valid`` and
        ``overflow``, the largest of every rank's output, candidate, survivor
        and capacity flags and the final NMS's survivor flag.
        ``tiled.stats`` holds this rank's ms by stage, each from its span
        (:mod:`..util.spans`): ``forward_ms``, ``retry_ms``, ``stitch_ms`` of
        the local stitch (as :class:`TiledInference`'s), ``exchange_ms``
        (every ``ranks.exchange``, the first and those of the restored rows:
        waits for the slowest rank included), ``final_nms_ms``
        (``ranks.final_rounds`` less its exchanges: the rounds and their
        suppression tests), ``readback_ms`` (``tiled.readback``),
        ``total_ms`` (``ranks.call``, the outer span); ``exchange_bytes``
        (what this rank received), ``rounds`` and ``restored`` (the final
        NMS's runs, and the suppressed rows that rejoined), the local
        stitch's NMS passes (``nms``) and the final NMS's (``final_nms``).
    """
    group = mesh_group(tiled.mesh) if group is None else group
    p, r = dist.get_world_size(group), dist.get_rank(group)
    model = tiled.model
    dev = model.device
    width = _pack_width(model)
    with span('ranks.call') as call:
        flat, t_local, residual = tiled.candidates(image, score_thresh, mask, point_mask,
                                                   point_mask_exclusive, part=(r, p))
        stats = tiled.stats
        local = pool = torch.zeros((0, width), dtype=torch.float32, device=dev)
        overflow, stats['stitch_ms'], stats['exchange_ms'] = residual, 0., 0.
        if flat is not None:
            compact, num_valid, overflow, stitched = tiled._stitch(flat)
            overflow = residual or overflow
            local = _pack(compact, min(num_valid, compact['valid'].shape[0]))
            gone = stitched['candidates'] & ~stitched['valid']   # the local stitch's suppressed
            pool = _pack({k: stitched[k][gone] for k in KEYS + ('order',)}, int(gone.sum()))

        cat, info, received = _exchange(local, group, (t_local, int(overflow)), stats)
        det, keep, surv_ovf, back_bytes = _final_rounds(tiled, cat, pool, group)
        stats['exchange_bytes'] = received + back_bytes

        with span('tiled.readback') as sp:
            # by score as one process orders them, ties in its flat order
            kept = _by_score(keep, det['scores'])[:int(keep.sum())]
            out = {k: det[k][kept].cpu().numpy() for k in KEYS}
        stats['readback_ms'] = sp.ms
    stats['total_ms'] = call.ms
    out['num_tiles'] = int(info[:, 1].sum())
    out['num_valid'] = int(keep.sum())
    out['overflow'] = bool(info[:, 2].max()) or bool(surv_ovf)
    return out


def tta_inference(tiled: TiledInference, image: np.ndarray, reps: int = 4, **kwargs) -> dict:
    """Test-time augmentation over flips: tiled inference on flipped copies,
    detections flipped back, merged by one final NMS on the model's device.

    Args:
        reps: 1 = identity, 2 = + horizontal flip, 4 = + vertical and both.
    """
    h, w = image.shape[:2]
    variants = [(False, False), (True, False), (False, True), (True, True)][:reps]
    merged = {k: [] for k in KEYS}
    total_tiles = 0

    def _flip(a, fx, fy):
        if fx:
            a = a[:, ::-1]
        if fy:
            a = a[::-1]
        return np.ascontiguousarray(a)

    for fx, fy in variants:
        kw = dict(kwargs)
        for mk in ('mask', 'point_mask'):
            if kw.get(mk) is not None:
                kw[mk] = _flip(np.asarray(kw[mk]), fx, fy)
        res = tiled(_flip(image, fx, fy), **kw)
        total_tiles += res.get('num_tiles', 0)
        cons, boxes, locs = res['contours'].copy(), res['boxes'].copy(), res['locations'].copy()
        four = res['fourier'].copy()
        if fx:
            cons[..., 0] = (w - 1) - cons[..., 0]
            locs[..., 0] = (w - 1) - locs[..., 0]
            boxes = np.stack([(w - 1) - boxes[:, 2], boxes[:, 1],
                              (w - 1) - boxes[:, 0], boxes[:, 3]], -1)
            four[..., 0:2] = -four[..., 0:2]   # mirror x: negate the (a, b) coefficients
        if fy:
            cons[..., 1] = (h - 1) - cons[..., 1]
            locs[..., 1] = (h - 1) - locs[..., 1]
            boxes = np.stack([boxes[:, 0], (h - 1) - boxes[:, 3],
                              boxes[:, 2], (h - 1) - boxes[:, 1]], -1)
            four[..., 2:4] = -four[..., 2:4]   # mirror y: negate the (c, d) coefficients
        for k, v in zip(KEYS, (cons, boxes, res['scores'], res['classes'], locs, four)):
            merged[k].append(v)
    cat = {k: np.concatenate(v) for k, v in merged.items()}
    dev = tiled.model.device
    boxes = torch.from_numpy(np.ascontiguousarray(cat['boxes'])).to(dev)
    keep = nms_padded(boxes, torch.from_numpy(cat['scores']).to(dev),
                      torch.ones(len(boxes), dtype=torch.bool, device=dev),
                      tiled.model.nms_thresh).cpu().numpy()
    out = {k: v[keep] for k, v in cat.items()}
    out['num_tiles'] = total_tiles
    return out
