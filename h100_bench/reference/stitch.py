"""Plain reference of tiled CPN inference over a mosaic and of the stitch.

The published tiled inference (celldetection v0.4.9,
``celldetection/util/util.py: get_tiling_slices``, ``models/inference.py``):
fixed 1024² windows at a stride, the last window of an axis stop-anchored at
the mosaic's edge; each window's detections in mosaic coordinates; a
contour dropped where it reaches into a ``border`` px band along a side of
its window that is not the mosaic's edge, or where its box is under
``min_size`` px on a side; then one greedy NMS over all windows' candidates
removes the duplicates of the overlaps. Imports torch and numpy alone.
"""
import numpy as np
import torch

from . import cpn


def tiling(height: int, width: int, tile: int, stride: int):
    """Window corners and interior sides, row-major: ``(offsets [T, 2] (x, y)
    float32, borders [T, 4] bool (top, right, bottom, left))``."""
    def starts(side):
        if tile >= side:
            return [0]
        steps = int(np.ceil((side - tile) / stride))
        stops = np.minimum(np.arange(tile, tile + steps * stride + 1, stride), side)
        return list(np.maximum(0, stops - tile))
    offs, borders = [], []
    for y in starts(height):
        for x in starts(width):
            offs.append((x, y))
            borders.append((y != 0, x + tile != width, y + tile != height, x != 0))
    return np.asarray(offs, np.float32), np.asarray(borders, bool)


def border_keep(contours, offsets, borders, tile: int, border: float):
    """``[N]``: no point of the contour (mosaic coordinates) lies in a border
    band of an interior side of its window (``offsets``, ``borders`` per row)."""
    local = contours - offsets[:, None, :]
    x, y = local[..., 0], local[..., 1]
    viol = (((y <= border).any(-1) & borders[:, 0])
            | ((x >= tile - border).any(-1) & borders[:, 1])
            | ((y >= tile - border).any(-1) & borders[:, 2])
            | ((x <= border).any(-1) & borders[:, 3]))
    return ~viol


def size_keep(boxes, min_size: float):
    return ((boxes[:, 2] - boxes[:, 0]) >= min_size) & ((boxes[:, 3] - boxes[:, 1]) >= min_size)


def window_calls(module, p, image, cfg, prec, thresh, mix, factor: int = 8):
    """The reference's padded decode of every window of ``image`` (``[H, W, 3]``
    uint8 on the device), one window a call, in mosaic coordinates: one pass
    at ``max_detections`` rows, then, for windows whose foreground exceeds
    that, again at 2x, 4x, ... up to ``factor`` x, as the tiled inference
    retries them."""
    tile, k = mix['tile'], cfg['max_detections']
    offs, _ = tiling(image.shape[0], image.shape[1], tile, mix['stride'])
    dense, calls = [], []

    def decode(t, cap):
        x0, y0 = offs[t].astype(int)
        with cpn.exact_fp32():
            dec = cpn.decode(dense[t], (tile, tile), cfg, thresh, cap)
        off = torch.tensor([x0, y0], dtype=torch.float32, device=image.device)
        for key in ('contours', 'locations', 'contour_proposals'):
            dec[key] = dec[key] + (off if key == 'locations' else off[None])
        dec['all_refined'] = tuple(c + off[None] for c in dec['all_refined'])
        dec['boxes'] = dec['boxes'] + torch.cat([off, off])
        return dec

    for x0, y0 in offs.astype(int):
        x = image[y0:y0 + tile, x0:x0 + tile][None].float() / 255.
        with cpn.exact_fp32():
            dense.append(cpn.dense_forward(module, p, x, cfg, prec))
        calls.append(decode(len(dense) - 1, k))
    cap, active = k, list(range(len(offs)))
    while True:
        active = [t for t in active if int(calls[t]['fg_count'][0]) > cap]
        cap *= 2
        if not active or cap > k * factor:
            return calls
        calls += [decode(t, cap) for t in active]


def windows_of_calls(calls, tiles: int, batch: int, capacity: int, factor: int):
    """Each window's decoded rows from a mosaic's padded forwards in call order:
    one pass over the windows in batches of ``batch``, then the capacity
    retries (windows whose foreground exceeds the capacity, again at 2x, 4x,
    ... up to ``factor`` x, in window order). Returns ``(per, order)``: each
    window's rows (a batch of one), and the windows in the stitch's flat
    order, the retried ones after all others."""
    per, stream = {}, iter(calls)

    def take(ids):
        for start in range(0, len(ids), batch):
            out = next(stream)
            for j, t in enumerate(ids[start:start + batch]):
                per[t] = {key: (None if v is None else tuple(x[j:j + 1] for x in v)
                                if isinstance(v, tuple) else v[j:j + 1]) for key, v in out.items()}
    take(list(range(tiles)))
    cap, active, retried = capacity, list(range(tiles)), []
    while True:
        active = [t for t in active if int(per[t]['fg_count'][0]) > cap]
        cap *= 2
        if not active or cap > capacity * factor:
            break
        retried += [t for t in active if t not in retried]
        take(active)
    return per, [t for t in range(tiles) if t not in retried] + sorted(retried)


ROWS = ('contours', 'boxes', 'scores', 'locations', 'fourier')


def stitch(per: dict, order, offsets, borders, cfg: dict, mix: dict):
    """The stitch of the windows' rows: flattened in ``order``, each row valid
    if it is one of its window's foreground rows and passes the filters, one
    greedy NMS over all of them, the kept rows by descending score. Returns
    ``(rows, valid, final)``: the flat rows, their validity before the NMS,
    and the kept rows as numpy arrays."""
    rows = {key: torch.cat([per[t][key][0] for t in order]) for key in ROWS}
    dev = rows['scores'].device
    tile_of = torch.cat([torch.full((per[t]['scores'].shape[1],), t) for t in order]).to(dev)
    fg = torch.cat([torch.arange(per[t]['scores'].shape[1]) < int(per[t]['fg_count'][0])
                    for t in order]).to(dev)
    offs = torch.as_tensor(offsets, device=dev)[tile_of]
    valid = fg & border_keep(rows['contours'], offs, torch.as_tensor(borders, device=dev)[tile_of],
                             mix['tile'], mix['border']) & size_keep(rows['boxes'], mix['min_box'])
    rows['valid'] = cpn.greedy_nms(rows['boxes'], rows['scores'], valid, cfg['nms_thresh'])
    return rows, valid, kept_rows(rows)


def kept_rows(rows: dict) -> dict:
    keep = rows['valid']
    order = torch.sort(torch.where(keep, rows['scores'], -torch.inf), descending=True,
                       stable=True).indices[:int(keep.sum())]
    return {key: rows[key][order].cpu().numpy() for key in ROWS}
