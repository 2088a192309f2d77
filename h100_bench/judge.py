"""The comparison that decides ``correct``: what the timed path produced, judged by the reference.

Numbers of two kinds. Gaps between the program's values and the reference's,
at the program's own selections (the reference works every value out again
from the images and the weights): they may differ by rounding, and the
limits of ``limits/<cell>.json`` bound them. Replays of the program's
discrete steps on the program's own inputs (the refinement's pixel steps,
the greedy NMS, the tile filters, the compaction): exact, limit 0. Where
the check follows the program's own intermediate values, the values that
feed it are themselves held against the reference first.
"""
import numpy as np
import torch

from .reference import cpn, stitch

_KEEP = ('dense_scores', 'fg_index', 'fg_count', 'valid', 'scores', 'locations', 'fourier',
         'contour_proposals', 'all_refined', 'contours', 'boxes')
def kept_outputs(out: dict) -> dict:
    """The outputs of a padded CPN inference that the checks read (references, no copies)."""
    return {k: out[k] for k in _KEEP}


def _max(x) -> float:
    return float(x.max()) if x.numel() else 0.


def judge_tiles(prog: dict, ref: dict, cfg: dict, nms_thresh: float, offsets=None) -> dict:
    """Numbers of one batch: ``prog`` the program's padded outputs, ``ref`` the
    reference's dense maps of the same images (float32, TF32 off).

    With ``offsets`` (``[B, 2]``, a mosaic's windows) the program's outputs are
    in mosaic coordinates: the gaps are taken after the offsets are taken off
    again, and the two replays that need the program's own window coordinates
    or its NMS (the refinement's pixel steps, the per-image NMS) are left to
    the caller.
    """
    size = tuple(ref['refinement'].shape[1:3])
    lr = ref['scores'][..., 0].float()
    lp = prog['dense_scores'][..., 0].float()
    b, h, w = lr.shape
    std = lr.std()
    idx = prog['fg_index'].long()
    k = idx.shape[1]
    pre = torch.arange(k, device=idx.device)[None] < prog['fg_count'].clamp(max=k)[:, None]
    flat = lr.reshape(b, -1)
    sel = torch.zeros_like(flat, dtype=torch.bool).scatter_(1, idx, pre)
    lowest = torch.where(sel, flat, torch.inf).amin(1)
    highest_left = torch.where(sel, -torch.inf, flat).amax(1)
    swaps = 0
    for i in range(b):
        n = int(pre[i].sum())
        top = torch.zeros_like(sel[i]).scatter_(0, torch.topk(flat[i], n).indices, True)
        swaps += int((sel[i] & ~top).sum())
    out = dict(dense_gap=float((lp - lr).abs().max() / std),
               topk_gap=float((highest_left - lowest).clamp(min=0).max() / std),
               topk_swaps=swaps)
    again = torch.sigmoid(cpn.gather_hw(lp[..., None], idx)[..., 0])
    out['score_replay'] = _max((prog['scores'] - again).abs()[pre])
    order = cfg['order']
    scale = torch.tensor([size[1] / w, size[0] / h], device=lr.device)
    fr = cpn.gather_hw(ref['fourier'].reshape(b, h, w, -1, 4)[..., :order, :], idx) * \
        scale.repeat_interleave(2)
    loc = cpn.gather_hw(cpn.abs_locations(ref['locations']), idx) * scale
    shift = 0. if offsets is None else offsets.to(loc.dtype)[:, None]
    out['location_gap'] = _max((prog['locations'] - shift - loc).abs().amax(-1)[pre])
    proposals = cpn.contours_from_fourier(fr, loc, cfg['samples'])
    shift = 0. if offsets is None else offsets.to(loc.dtype)[:, None, None]
    out['proposal_gap'] = _max((prog['contour_proposals'] - shift - proposals).abs()
                               .amax((-1, -2))[pre])
    c = prog['contours']
    boxes = torch.cat((c.amin(-2), c.amax(-2)), -1)
    wrong = (prog['boxes'] != boxes).any(-1)
    if prog['all_refined']:
        wrong |= (c != prog['all_refined'][-1]).flatten(2).any(-1)
    out['box_mismatch'] = int(wrong[pre].sum())
    if offsets is not None:
        return out
    prev, gaps = prog['contour_proposals'], []
    for step in prog['all_refined']:
        again = cpn.clip_xy(cpn.refine_step(prev, ref['refinement'], size), size)
        gaps.append(_max((step - again).abs().amax((-1, -2))[pre]))
        prev = step
    out['refine_gap'] = max(gaps) if gaps else 0.
    mism = 0
    for i in range(b):
        keep = cpn.greedy_nms(prog['boxes'][i], prog['scores'][i], pre[i], nms_thresh)
        mism += int((keep != prog['valid'][i]).sum())
    out['nms_mismatch'] = mism
    return out


def merge(numbers: dict, got: dict) -> dict:
    """The largest of each gap and the sum of each count."""
    for key, v in got.items():
        numbers[key] = numbers.get(key, 0) + v if isinstance(v, int) else \
            max(numbers.get(key, 0.), v)
    return numbers


def judge_mosaic(calls, final: dict, ref_window, geom: dict, cfg: dict, mix: dict):
    """Numbers of one mosaic, and the stitch's inputs as the reference works them out.

    ``calls``: the program's padded forwards of the mosaic's windows, in call
    order (:func:`kept_outputs` of each); ``final``: the result it handed
    back (numpy); ``ref_window(t)``: the reference's dense maps of window
    ``t``; ``geom``: ``offsets``, ``borders`` (the reference's tiling) and
    ``factor``, the largest capacity retry. Every window is judged as a tile
    is (:func:`judge_tiles`); then the reference works the stitch out again
    from the windows' rows (the filters, one greedy NMS over all windows, the
    kept rows by descending score) and compares it with ``final`` exactly.
    """
    tiles = len(geom['offsets'])
    per, order = stitch.windows_of_calls(calls, tiles, mix['batch'], cfg['max_detections'],
                                         geom['factor'])
    numbers = {}
    offs = torch.from_numpy(geom['offsets'])
    for t in range(tiles):
        dev = per[t]['scores'].device
        merge(numbers, judge_tiles(per[t], ref_window(t), cfg, cfg['nms_thresh'],
                                   offsets=offs[t:t + 1].to(dev)))
    rows, valid, want = stitch.stitch(per, order, geom['offsets'], geom['borders'], cfg, mix)
    n = min(len(want['scores']), len(final['scores']))
    differ = np.zeros(n, bool)
    for key, v in want.items():
        differ |= (np.asarray(final[key][:n]) != v[:n]).reshape(n, -1).any(-1)
    numbers['output_mismatch'] = int(differ.sum()) + abs(len(want['scores']) - len(final['scores']))
    return numbers, dict(boxes=rows['boxes'], scores=rows['scores'], valid=valid)
