"""CPN target encoding on the host (numpy and scipy, no cv2).

Counterpart of ``celldetection_tpu/data/cpn.py``: ``efd`` (34-91),
``fourier2contour`` (94-107), ``labels2contours`` (110-139),
``contours2fourier`` (165-193), ``mask_labels_by_distance_`` (429-434),
``labels2distances`` with its helpers (437-502), ``CPNTargetGenerator``
(505-615), and the rendering of contours into label images:
``contours2boxes``, ``render_contour``, ``clip_contour_``,
``contours2labels`` and ``resolve_label_channels`` (196-287); also
``labels2contour_list`` (142), ``masks2labels`` (148), ``contours2properties``
(290), ``filter_contours_by_intensity`` (300) and ``draw_contours`` (315).

The JAX package calls four functions of OpenCV here, and the port has its own
numpy versions that give the same output, point for point and bit for bit:

* :func:`outer_borders` is ``cv2.findContours(RETR_EXTERNAL,
  CHAIN_APPROX_NONE)``: Suzuki-Abe border following of the outer borders,
  8-connected, with OpenCV's raster scan, its marking of visited border
  pixels and its rule for which outer borders count as external, so the
  same start point, direction and number of contours come out.
* :func:`chamfer_distance` is ``cv2.distanceTransform(DIST_L2, 3)``: the 3x3
  chamfer with OpenCV's 16.16 fixed-point weights for 0.955 and 1.3693, one
  forward and one backward pass, each row's recurrence solved as a running
  minimum (``np.minimum.accumulate``).
* :func:`render_contour` is ``cv2.drawContours(thickness=-1)``, which is
  ``cv2.fillPoly``: each edge drawn as an 8-connected line, then the edges
  filled by scanline in 16.16 fixed point (:func:`_fill_polygon`), so
  self-intersecting contours and contours of 1 or 2 points come out as cv2's.
  With ``thickness > 0`` it, :func:`draw_contours` and
  :func:`contours2overlay` draw outlines as ``cv2.drawContours`` does:
  ``cv2.line`` of each segment (``LINE_8``; :func:`._draw.polylines`).
* :func:`masks2labels` is ``cv2.connectedComponents``: ``scipy.ndimage.label``
  with 4- or 8-connectivity, renumbered in cv2's order (:func:`_cv2_order`).
* :func:`resolve_label_channels` dilates as ``cv2.dilate`` with the 3x3
  cross of ``cv2.getStructuringElement(MORPH_CROSS)``.
* :func:`hsv2rgb_uint8` is ``cv2.cvtColor(COLOR_HSV2RGB)`` of one uint8
  pixel, which :func:`contours2overlay` (327-430, with its shared-memory
  multi-process renderer) draws its random colours with.
"""
from collections import OrderedDict

import numpy as np

from ._regionprops import regionprops
from .misc import resample_contours
from .segmentation import filter_instances_

__all__ = ['CPNTargetGenerator', 'efd', 'fourier2contour', 'labels2contours',
           'labels2contour_list', 'masks2labels', 'contours2properties',
           'filter_contours_by_intensity', 'draw_contours',
           'contours2fourier', 'mask_labels_by_distance_', 'labels2distances',
           'outer_borders', 'chamfer_distance', 'contours2boxes', 'render_contour',
           'clip_contour_', 'contours2labels', 'resolve_label_channels', 'contours2overlay',
           'hsv2rgb_uint8']

# cv2's values of the constants the JAX package passes
RETR_EXTERNAL, CHAIN_APPROX_NONE, DIST_L2 = 0, 1, 2


def efd(contour, order: int = 10, epsilon: float = 1e-6, autoclose: bool = True):
    """Elliptic Fourier descriptor (Kuhl and Giardina) of closed 2d contours.

    Args:
        contour: ``[..., num_points, 2]``, or an object array of contours of
            different lengths (each processed alone).
        order: Descriptor order; 1 gives ellipses.
        epsilon: Guards zero-length segments.
        autoclose: Close contours whose end points differ.

    Returns:
        ``(coefficients [..., order, 4] as (a, b, c, d), locations [..., 2])``:
        the first contour point plus the DC terms A0, C0.
    """
    if isinstance(contour, np.ndarray) and contour.dtype == object:
        results = [efd(c, order=order, epsilon=epsilon) for c in contour]
        return np.array([r[0] for r in results]), np.array([r[1] for r in results])

    contour = np.asarray(contour, dtype=float)
    if autoclose and not np.allclose(contour[..., 0, :], contour[..., -1, :]):
        contour = np.concatenate((contour, contour[..., :1, :]), axis=-2)
    elif not np.allclose(contour[..., 0, :], contour[..., -1, :]):
        raise ValueError('contours must be closed (first point == last point)')

    dxy = np.diff(contour, axis=-2)                          # (..., p, 2)
    dt = np.sqrt(np.sum(np.square(dxy), axis=-1)) + epsilon  # (..., p)
    t = np.concatenate([np.zeros(dt.shape[:-1] + (1,)), np.cumsum(dt, axis=-1)], -1)
    T = t[..., -1:]                                          # total arc length

    phi = (2 * np.pi) * t / T                                # (..., p + 1)
    orders = np.arange(1, order + 1, dtype=phi.dtype)
    const = T / (2. * np.square(orders) * np.square(np.pi))  # T / (2 k^2 pi^2)
    phi_k = phi[..., None, :] * orders[..., None]            # (..., order, p + 1)
    d_cos = np.cos(phi_k[..., 1:]) - np.cos(phi_k[..., :-1])
    d_sin = np.sin(phi_k[..., 1:]) - np.sin(phi_k[..., :-1])

    vx = (dxy[..., 0] / dt)[..., None, :]
    vy = (dxy[..., 1] / dt)[..., None, :]
    coefficients = np.stack([
        const * np.sum(vx * d_cos, axis=-1),                 # a_k
        const * np.sum(vx * d_sin, axis=-1),                 # b_k
        const * np.sum(vy * d_cos, axis=-1),                 # c_k
        const * np.sum(vy * d_sin, axis=-1),                 # d_k
    ], axis=-1)

    # DC terms A0 and C0 relative to the first contour point
    xi = np.cumsum(dxy[..., 0], axis=-1) - (dxy[..., 0] / dt) * t[..., 1:]
    delta = np.cumsum(dxy[..., 1], axis=-1) - (dxy[..., 1] / dt) * t[..., 1:]
    t_sq_diff = np.diff(t ** 2, axis=-1)
    a0 = np.sum((dxy[..., 0] / (2 * dt)) * t_sq_diff + xi * dt, axis=-1) / T[..., 0]
    c0 = np.sum((dxy[..., 1] / (2 * dt)) * t_sq_diff + delta * dt, axis=-1) / T[..., 0]
    locations = np.stack((contour[..., 0, 0] + a0, contour[..., 0, 1] + c0), axis=-1)
    return np.array(coefficients), locations


def fourier2contour(fourier: np.ndarray, locations: np.ndarray, samples: int = 64,
                    sampling=None):
    """Numpy inverse EFD: ``[..., order, 4]`` coefficients → ``[..., samples, 2]`` contours."""
    order = fourier.shape[-2]
    if sampling is None:
        sampling = np.linspace(0, 1.0, samples)
    samples = sampling.shape[-1]
    sampling = sampling[..., None, :]
    c = 2 * np.pi * np.arange(1, order + 1)[..., None] * sampling
    c_cos, c_sin = np.cos(c), np.sin(c)
    con = np.zeros(fourier.shape[:-2] + (samples, 2))
    con += locations[..., None, :]
    con += (fourier[..., None, (1, 3)] * c_sin[..., None]).sum(-3)
    con += (fourier[..., None, (0, 2)] * c_cos[..., None]).sum(-3)
    return con


# -- outer borders (cv2.findContours, RETR_EXTERNAL, CHAIN_APPROX_NONE) ------

# Freeman codes 0..7 as (dy, dx), counter-clockwise from "right" in image
# coordinates (OpenCV's CV_INIT_3X3_DELTAS and icvCodeDeltas); the table
# repeats so that a search may run past code 7 without a modulo.
_STEPS = ((0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1)) * 2
_VISITED = 2              # OpenCV's nbd of a border pixel once visited
_VISITED_RIGHT = -126     # nbd | -128 (int8): visited, and its right neighbour is background


def _follow_border(img: np.ndarray, y0: int, x0: int) -> list:
    """Trace the outer border that starts at ``(y0, x0)`` of the padded int8
    image ``img`` (OpenCV's ``icvFetchContour``), marking its pixels in place.

    Returns the border's ``(x, y)`` points in visiting order.
    """
    s_end = s = 4                               # outer border: the search starts at "left"
    while True:
        s = (s - 1) & 7
        y1, x1 = y0 + _STEPS[s][0], x0 + _STEPS[s][1]
        if img[y1, x1] != 0 or s == s_end:
            break
    if s == s_end:                              # a single pixel (its left neighbour is 0)
        img[y0, x0] = _VISITED_RIGHT
        return [(x0, y0)]
    points = []
    y3, x3 = y0, x0
    while True:
        s_end = s
        while s < 15:
            s += 1
            y4, x4 = y3 + _STEPS[s][0], x3 + _STEPS[s][1]
            if img[y4, x4] != 0:
                break
        s &= 7
        if 1 <= s <= s_end:                     # the search passed the right neighbour
            img[y3, x3] = _VISITED_RIGHT
        elif img[y3, x3] == 1:
            img[y3, x3] = _VISITED
        points.append((x3, y3))
        if y4 == y0 and x4 == x0 and y3 == y1 and x3 == x1:
            return points
        y3, x3 = y4, x4
        s = (s + 4) & 7


def _scan_borders(img: np.ndarray) -> list:
    """OpenCV's raster scan for external outer borders over the padded int8
    image ``img`` (marked in place); returns each border's points."""
    h, width = img.shape[0] - 2, img.shape[1] - 1
    borders = []
    for y in range(1, h + 1):
        row = img[y]
        x, prev, lnbd = 1, 0, 0                 # lnbd: the column of the last border met
        while True:
            run = np.flatnonzero(row[x:width] != prev)   # skip the run equal to prev
            if not run.size:
                break
            x += int(run[0])
            p = int(row[x])
            if prev == 0 and p == 1:            # an outer border starts here
                if row[lnbd] <= 0:              # not inside a border already met
                    borders.append(_follow_border(img, y, x))
                    prev = int(row[x])          # the scan goes on past the marked start
                    x += 1
                    continue
            elif p == 0 and prev >= 1 and prev & -2:   # a hole starts (not followed)
                lnbd = x - 1
            prev = p
            if prev & -2:
                lnbd = x
            x += 1
    return borders


def outer_borders(mask: np.ndarray, offset=(0, 0)) -> list:
    """The external outer borders of a binary image, as ``cv2.findContours``
    with ``RETR_EXTERNAL`` and ``CHAIN_APPROX_NONE`` gives them.

    Args:
        mask: ``[h, w]``; non-zero is foreground.
        offset: ``(x, y)`` added to every point.

    Returns:
        A list of ``int32 [n, 1, 2]`` arrays of ``(x, y)`` points, in OpenCV's
        order: the raster scan meets each border at its first pixel, the
        border is followed from there, and the list holds the borders last
        found first.
    """
    h, w = mask.shape
    img = np.zeros((h + 2, w + 2), np.int8)     # OpenCV pads by one background pixel
    img[1:-1, 1:-1] = mask != 0
    starts = (img[:, 1:] == 1) & (img[:, :-1] == 0)
    if not starts.any():
        return []
    # The common case, one border: the scan meets the first foreground pixel
    # first; if no unvisited pixel with background on its left remains after
    # following that border, no other border can start, and the scan is done.
    y0, x0 = divmod(int(np.argmax(starts)), w + 1)
    traced = img.copy()
    borders = [_follow_border(traced, y0, x0 + 1)]
    if ((traced[:, 1:] == 1) & (traced[:, :-1] == 0)).any():
        borders = _scan_borders(img)
    shift = np.asarray((offset[0] - 1, offset[1] - 1), np.int32)
    return [(np.asarray(b, np.int32) + shift)[:, None, :] for b in borders[::-1]]


def _only(name: str, value, implemented: int, meaning: str):
    """Raise unless ``value`` is the one cv2 constant the port implements."""
    if value != implemented:
        raise NotImplementedError(f'{name}={value!r}: the port implements only {name}='
                                  f'{implemented} ({meaning})')


def labels2contours(labels: np.ndarray, mode=RETR_EXTERNAL, method=CHAIN_APPROX_NONE,
                    flag_fragmented_inplace: bool = False, raise_fragmented: bool = True,
                    constant: int = -1) -> dict:
    """Label image ``[h, w]`` or ``[h, w, c]`` → ``{label: int32 [n, 1, 2] contour}``.

    Each instance's outer border is traced in its bounding-box crop
    (:func:`outer_borders`). A one-point contour is repeated to length 2. An
    instance with more than one external border is fragmented: it is set to
    ``constant`` in ``labels`` (``flag_fragmented_inplace``), raises
    (``raise_fragmented``) or is left out. ``mode`` and ``method`` keep the
    JAX package's positions; only cv2's ``RETR_EXTERNAL`` (0) and
    ``CHAIN_APPROX_NONE`` (1) are implemented.
    """
    _only('mode', mode, RETR_EXTERNAL, 'cv2.RETR_EXTERNAL')
    _only('method', method, CHAIN_APPROX_NONE, 'cv2.CHAIN_APPROX_NONE')
    if labels.ndim == 2:
        labels = labels[..., None]
    crops = []
    contours = OrderedDict()
    for channel in np.split(labels, labels.shape[2], 2):
        crops += [(p.label, p.image, *p.bbox[:2]) for p in regionprops(channel[..., 0])]
    for label, crop, oy, ox in crops:
        c = outer_borders(crop, offset=(ox, oy))
        if len(c) != 1:
            if flag_fragmented_inplace:
                labels[labels == label] = constant
            elif raise_fragmented:
                raise ValueError('Object labeled with multiple connected components.')
            continue
        c, = c
        if len(c) == 1:
            c = np.concatenate((c, c), axis=0)  # min length 2
        contours[label] = c
    if labels.shape[2] > 1:
        return OrderedDict(sorted(contours.items()))
    return contours


def labels2contour_list(labels: np.ndarray, **kwargs) -> list:
    """The contours of :func:`labels2contours` as a list of ``[n, 2]`` arrays."""
    if labels.ndim == 2:
        labels = labels[..., None]
    return [np.squeeze(i, 1) for i in labels2contours(labels, **kwargs).values()]


def _cv2_order(labels: np.ndarray, n: int, connectivity: int) -> np.ndarray:
    """Components renumbered as ``cv2.connectedComponents`` numbers them: by
    the first pixel in raster order for 4-connectivity (SAUF scans pixels),
    by the first 2x2 block in raster order of blocks for 8-connectivity
    (Spaghetti scans such blocks, and the pixels of a block are 8-connected)."""
    if n == 0:
        return labels
    ys, xs = np.nonzero(labels)
    w = labels.shape[1]
    key = ys * w + xs if connectivity == 4 else (ys // 2) * (w + 1) + xs // 2
    first = np.full(n + 1, np.iinfo(np.int64).max)
    np.minimum.at(first, labels[ys, xs], key)
    remap = np.zeros(n + 1, np.int64)
    remap[np.argsort(first[1:], kind='stable') + 1] = np.arange(1, n + 1)
    return remap[labels]


def masks2labels(masks, connectivity: int = 8, label_axis: int = 2, count: bool = False,
                 reduce=np.max, keepdims: bool = True):
    """Binary masks → label image of their connected components.

    Each mask's components (``connectivity`` 4 or 8) are numbered as cv2
    numbers them (:func:`_cv2_order`), offset by the count of the masks
    before it, as the JAX package counts cv2's labels; the per-mask images
    are stacked on ``label_axis`` and reduced by ``reduce``. Labels are
    int32, as cv2's default ``CV_32S``.
    """
    from scipy import ndimage
    if connectivity not in (4, 8):
        raise ValueError(f'connectivity must be 4 or 8, got {connectivity}')
    structure = ndimage.generate_binary_structure(2, 1 if connectivity == 4 else 2)
    labels = []
    cnt = 0
    for m in masks:
        b, n = ndimage.label(np.asarray(m, dtype=np.uint8) != 0, structure=structure)
        b = _cv2_order(b, n, connectivity).astype(np.int32)
        a = n + 1                                   # cv2's count includes the background
        if cnt > 0:
            b[b > 0] += cnt
        cnt += a - (1 if (a > 1 and 0 in b) else 0)
        labels.append(b)
    labels = np.stack(labels, label_axis)
    if reduce is not None:
        labels = reduce(labels, axis=label_axis, keepdims=keepdims)
    return (labels, cnt) if count else labels


def contours2fourier(contours: dict, order: int = 5, dtype=np.float32, batched: bool = True):
    """Per-label EFD into dense ``(max_label, order, 4)`` and ``(max_label, 2)`` arrays.

    ``batched`` pads all contours (closed, last point repeated: the repeated
    segments have about zero arc length and vanish from the integrals) and
    computes every descriptor in one vectorised pass.
    """
    max_label = int(np.max(list(contours.keys()))) if len(contours) else 0
    fouriers = np.zeros((max_label, order, 4), dtype=dtype)
    locations = np.zeros((max_label, 2), dtype=dtype)
    if not len(contours):
        return fouriers, locations
    items = [(k, (c.squeeze(1) if c.ndim == 3 else c)) for k, c in contours.items()]
    if batched and len(items) > 1:
        closed = [np.concatenate([c, c[:1]], 0).astype(float) for _, c in items]
        p = max(len(c) for c in closed)
        batch = np.stack([np.concatenate([c, np.repeat(c[-1:], p - len(c), 0)], 0)
                          for c in closed])
        coeffs, locs = efd(batch, order, autoclose=False)
        for i, (key, _) in enumerate(items):
            fouriers[key - 1] = coeffs[i]
            locations[key - 1] = locs[i]
    else:
        for key, contour in items:
            fourier, location = efd(contour, order)
            fouriers[key - 1] = fourier
            locations[key - 1] = location
    return fouriers, locations


# -- distances (cv2.distanceTransform, DIST_L2, mask 3) -----------------------

_HV = np.float32(0.955)                     # OpenCV's 3x3 weights for DIST_L2
_DIAG = np.float32(1.3693)
_FAR = np.float32(np.finfo(np.float32).max)  # beyond the image; sums saturate there
_LANES = 4
_STEP = np.array([np.float32(k * np.float64(_HV)) for k in range(_LANES + 1)])   # k a


def _relax(t: np.ndarray):
    """In place along the last axis: ``t[j] = min(t[j], t[j-1] + a)`` in
    float32, in order, as one sequential left-to-right pass computes it.

    Each round moves every chain one pixel on; the rounds stop when none
    improves (float addition is monotone, so the fixed point is the
    sequential result, rounding included).
    """
    while t.shape[-1] > 1:
        c = t[..., :-1] + _HV
        if not (c < t[..., 1:]).any():
            return
        np.minimum(t[..., 1:], c, out=t[..., 1:])


def _forward_row_blocks(u: np.ndarray, bg: np.ndarray):
    """One forward row as OpenCV 5 computes it between its first and last
    rows, in place: columns 0-3 and the tail sequentially, and every block
    of four columns from 4 on that ends before the last column at once.

    In a block, column ``k`` takes the minimum of its value from the row
    above, ``a`` times its distance to the nearest background column left of
    it in the block, and the column before the block plus ``(k + 1) a``
    (the constants rounded once). Values from the row above are not carried
    sideways inside a block: in exact arithmetic they never win there, but
    in float32 a tie of two paths can round either way.
    """
    w = u.shape[-1]
    nb = max(0, (w - 1 - _LANES) // _LANES)
    if nb == 0:
        _relax(u)
        return
    _relax(u[..., :_LANES])
    end = _LANES * (nb + 1)
    blk = u[..., _LANES:end].reshape(u.shape[:-1] + (nb, _LANES))
    lanes = np.arange(_LANES)
    last_bg = np.maximum.accumulate(np.where(bg[..., _LANES:end].reshape(blk.shape), lanes, -1),
                                    axis=-1)
    prev_bg = np.concatenate([np.full(last_bg.shape[:-1] + (1,), -1), last_bg[..., :-1]], -1)
    base = np.where(prev_bg >= 0, np.minimum(blk, _STEP[lanes - prev_bg]), blk)
    fg = ~bg[..., _LANES:end].reshape(blk.shape)
    # carries: each block's last column, a min-plus chain over blocks with step 4 a
    carry = np.concatenate([u[..., _LANES - 1:_LANES], np.where(fg[..., -1], base[..., -1], 0)],
                           -1)
    while True:
        nxt = np.where(fg[..., -1], np.minimum(base[..., -1], carry[..., :-1] + _STEP[_LANES]), 0)
        if np.array_equal(nxt, carry[..., 1:]):
            break
        carry[..., 1:] = nxt
    out = np.where(fg, np.minimum(base, carry[..., :-1, None] + _STEP[1:]), 0)
    u[..., _LANES:end] = out.reshape(u.shape[:-1] + (nb * _LANES,))
    if end < w:
        np.minimum(u[..., end], u[..., end - 1] + _HV, out=u[..., end])
        _relax(u[..., end:])


def chamfer_distance(mask: np.ndarray) -> np.ndarray:
    """``cv2.distanceTransform(mask, DIST_L2, 3)`` of ``[..., h, w]`` masks
    (OpenCV 5): the float32 distance of every non-zero pixel to the nearest
    zero pixel by the 3x3 chamfer.

    Two passes in float32: forward, top-down and left to right, with the
    neighbours up-left + b, up + a, up-right + b and left + a; backward,
    bottom-up and right to left, with down-right, down, down-left and right,
    for pixels above a. The forward pass of the rows between the first and
    the last is OpenCV's vectorised one (:func:`_forward_row_blocks`).
    Pixels beyond the image count as infinitely far (a mask without a zero
    gives float32's largest value). Leading axes are independent images.
    """
    fg = np.asarray(mask) != 0
    h, w = fg.shape[-2:]
    t = np.empty(fg.shape, np.float32)
    edge = np.full(fg.shape[:-2] + (w + 2,), _FAR, np.float32)
    above = edge.copy()
    for i in range(h):
        u = np.minimum(np.minimum(above[..., :-2], above[..., 2:]) + _DIAG,
                       above[..., 1:-1] + _HV)
        bg = ~fg[..., i, :]
        u[bg] = 0
        if 0 < i < h - 1:
            _forward_row_blocks(u, bg)
        else:
            _relax(u)
        t[..., i, :] = above[..., 1:-1] = u
    below = edge
    for i in range(h - 1, -1, -1):
        f = t[..., i, :]
        v = np.minimum(np.minimum(below[..., :-2], below[..., 2:]) + _DIAG,
                       below[..., 1:-1] + _HV)
        u = np.where(f > _HV, np.minimum(f, v), f)
        _relax(u[..., ::-1])
        t[..., i, :] = below[..., 1:-1] = u
    return t


def mask_labels_by_distance_(labels: np.ndarray, distances: np.ndarray, max_bg_dist: float,
                             min_fg_dist: float):
    """Inplace: the background ring → 0, the uncertain ring → -1 (left out of the loss)."""
    fg = np.any(labels > 0, axis=2)
    labels[fg & (distances <= max_bg_dist)] = 0
    labels[(distances > max_bg_dist) & (distances < min_fg_dist)] = -1


def _iter_instance_slices(channel: np.ndarray):
    """Yield ``(label_value, bbox_slices)`` for every instance in one label channel."""
    from scipy import ndimage
    for value, slices in enumerate(ndimage.find_objects(np.maximum(channel, 0)), 1):
        if slices is not None:
            yield value, slices


def _labels2distances_fg(labels, single_support):
    """One transform of the whole (non-overlapping) foreground, normalised per instance."""
    dist = chamfer_distance(single_support)
    if labels.size:
        flat = labels.max(-1) if labels.ndim == 3 else labels
        for value, slices in _iter_instance_slices(flat):
            inst = flat[slices] == value
            view = dist[slices]
            if inst.any():
                view[inst] /= max(float(view[inst].max()), 1e-6)
    return dist


def _labels2distances_instance(labels, single_support, protected_size=36):
    """Independent per-instance transforms, so touching instances keep separate peaks.

    Each instance's crop, padded by one background pixel, is transformed
    and normalised by its peak, unless it has at most ``protected_size``
    pixels: those keep their raw (clipped) distances, since normalising a
    2-px-wide object would raise its whole area to about 1 and erase the
    fg/bg bands. All crops go through one :func:`chamfer_distance` call,
    stacked with zero padding (background beyond a crop's own padding does
    not change its distances).
    """
    out = np.zeros(labels.shape[:2], dtype='float32')
    items = []
    for channel in np.moveaxis(labels, -1, 0):
        for value, slices in _iter_instance_slices(channel):
            inst = (channel[slices] == value) & single_support[slices]
            if inst.any():
                items.append((slices, inst))
    if not items:
        return out
    stack = np.zeros((len(items), max(i.shape[0] for _, i in items) + 2,
                      max(i.shape[1] for _, i in items) + 2), bool)
    for n, (_, inst) in enumerate(items):
        stack[n, 1:inst.shape[0] + 1, 1:inst.shape[1] + 1] = inst
    dist = chamfer_distance(stack)
    for n, (slices, inst) in enumerate(items):
        d = dist[n, 1:inst.shape[0] + 1, 1:inst.shape[1] + 1]
        peak = float(d.max())
        if peak > 0 and np.count_nonzero(inst) > protected_size:
            d = d / np.float32(peak)
        out[slices][inst] = np.minimum(d, 1.0)[inst]
    return out


def labels2distances(labels: np.ndarray, distance_type=DIST_L2, overlap_zero: bool = True,
                     per_instance: bool = True, **kwargs):
    """Per-instance normalised distance transform of ``[h, w, c]`` labels.

    Returns ``(distances, labels)``: distances in [0, 1] with instance
    centres at 1, and a copy of the labels with overlaps set to -1 when
    ``overlap_zero``. The transform is :func:`chamfer_distance`, cv2's
    ``DIST_L2`` (2), the one ``distance_type`` implemented.
    """
    _only('distance_type', distance_type, DIST_L2, 'cv2.DIST_L2')
    labels = labels.copy()
    support = np.count_nonzero(labels > 0, axis=2)
    if overlap_zero:
        labels[support > 1] = -1
        single = support == 1
    else:
        single = support > 0
    fn = _labels2distances_instance if per_instance else _labels2distances_fg
    return np.clip(fn(labels, single, **kwargs), 0., 1.), labels


# --- rendering contours into label images (cv2.drawContours and cv2.dilate) ---

_XY_SHIFT = 16   # cv2's fixed-point fraction bits of the polygon fill


def contours2boxes(contours: np.ndarray) -> np.ndarray:
    """Contours ``[n, s, 2]`` → ``(x0, y0, x1, y1)`` boxes ``[n, 4]``."""
    if len(contours):
        return np.concatenate((contours.min(1), contours.max(1)), 1)
    return np.empty((0, 4))


def _line_pixels(x0: int, y0: int, x1: int, y1: int):
    """The pixels of cv2's 8-connected line (``LineIterator``, left to right):
    Bresenham along the major axis, the minor step taken when the error
    term is negative, so a tie stays on the row (or column) of the start."""
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, abs(y1 - y0)
    sy = 1 if y1 >= y0 else -1
    major, minor = (dy, dx) if dy > dx else (dx, dy)
    k = np.arange(major + 1, dtype=np.int64)
    m = (2 * minor * k + major - 1) // (2 * major) if major else k
    if dy > dx:
        return x0 + m, y0 + sy * k
    return x0 + k, y0 + sy * m


def clip_line(width: int, height: int, p1, p2):
    """cv2's ``clipLine`` to ``[0, width - 1] x [0, height - 1]``: ``(p1, p2,
    inside)``, the end points as cv2 leaves them (moved onto the border, in
    part even where the segment misses the rectangle and ``inside`` is False)."""
    right, bottom = width - 1, height - 1
    (x1, y1), (x2, y2) = (tuple(int(v) for v in p) for p in (p1, p2))

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (x1, y1), (x2, y2), (c1 | c2) == 0


def _trunc_div(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _fill_polygon(img: np.ndarray, pts: np.ndarray, val):
    """``cv2.fillPoly`` of one polygon of integer points, 8-connected, no
    shift (what ``cv2.drawContours(thickness=-1)`` does): every edge is drawn
    as a line (``CollectPolyEdges``), then the non-horizontal edges are
    filled by scanline with even-odd pairing (``FillEdgeCollection``): edges
    in 16.16 fixed point with slopes truncated toward zero, the active list
    merged by x as each edge starts and bubble-sorted (stably) after each
    row, each span from the ceiling of its left x to the floor of its right.
    A point may leave the image: a line that leaves it is drawn between the
    end points ``clip_line`` gives, and its edge takes their x (and their y
    where they differ) while it keeps the rows of the unclipped line; rows
    above the image are walked, not drawn."""
    _fill_edges(img, _poly_edges(img, pts, val, []), val)


def _fill_polygons(img: np.ndarray, polygons, val):
    """``cv2.drawContours(img, polygons, -1, val, -1)`` (``fillPoly`` of several
    polygons): the edges of all of them in one collection, filled with
    even-odd pairing, so where polygons overlap an even count leaves a hole."""
    edges = []
    for pts in polygons:
        if len(pts):
            _poly_edges(img, np.asarray(pts, np.int64).reshape(-1, 2), val, edges)
    _fill_edges(img, edges, val)


def _poly_edges(img: np.ndarray, pts: np.ndarray, val, edges: list) -> list:
    """cv2's ``CollectPolyEdges`` of one polygon: its lines drawn, its
    non-horizontal edges appended to ``edges`` (see :func:`_fill_polygon`)."""
    h, w = img.shape[:2]
    px, py = (int(v) for v in pts[-1])
    for qx, qy in pts.tolist():
        (cx0, cy0), (cx1, cy1) = (px, py), (qx, qy)
        if not (0 <= min(px, qx) and max(px, qx) < w and 0 <= min(py, qy) and max(py, qy) < h):
            (cx0, ey0), (cx1, ey1), inside = clip_line(w, h, (px, py), (qx, qy))
            if inside:
                xs, ys = _line_pixels(cx0, ey0, cx1, ey1)
                img[ys, xs] = val
            if ey0 != ey1:
                cy0, cy1 = ey0, ey1
        else:
            xs, ys = _line_pixels(px, py, qx, qy)
            img[ys, xs] = val
        if py != qy:
            slope = _trunc_div((cx1 - cx0) << _XY_SHIFT, cy1 - cy0)
            (x, y), top = ((cx0, cy0), py) if py < qy else ((cx1, cy1), qy)
            edges.append([top, max(py, qy), (x << _XY_SHIFT) + (top - y) * slope, slope])
        px, py = qx, qy
    return edges


def _fill_edges(img: np.ndarray, edges: list, val):
    """cv2's ``FillEdgeCollection`` (see :func:`_fill_polygon`)."""
    h, w = img.shape[:2]
    if len(edges) < 2:
        return
    edges.sort(key=lambda e: (e[0], e[2], e[3]))
    one = (1 << _XY_SHIFT) - 1
    y_end = min(max(e[1] for e in edges), h)
    active, i = [], 0
    for y in range(edges[0][0], y_end):
        merged, draw, prev, j = [], False, None, 0
        while True:
            last = active[j] if j < len(active) else None
            if last is not None and last[1] == y:      # the edge ends above this row
                j += 1
                continue
            new = edges[i] if i < len(edges) and edges[i][0] == y else None
            if last is not None and (new is None or last[2] < new[2]):
                cur, j = last, j + 1
            elif new is not None:                      # an edge starts on this row
                cur, i = new, i + 1
            else:
                break
            if draw:
                left, right = (cur, prev) if prev[2] > cur[2] else (prev, cur)
                x0, x1 = (left[2] + one) >> _XY_SHIFT, right[2] >> _XY_SHIFT
                if y >= 0 and x0 < w and x1 >= 0:
                    img[y, max(x0, 0):min(x1, w - 1) + 1] = val
                prev[2] += prev[3]
                cur[2] += cur[3]
            merged.append(cur)
            prev, draw = cur, not draw
        active = sorted(merged, key=lambda e: e[2])


def render_contour(contour, val=1, dtype='int32', round=False, reference=None, thickness=-1):
    """Rasterize one contour into a tight crop; returns ``(crop, (xmin, xmax), (ymin, ymax))``.

    The points are truncated to int32 as the JAX package passes them to
    ``cv2.drawContours``, and drawn clipped to the crop as cv2 clips
    (``reference`` need not bound the contour): filled (``thickness < 0``,
    :func:`_fill_polygon`), or as an outline of ``thickness`` pixels
    (:func:`._draw.polylines`).
    """
    if thickness == 0:
        raise ValueError('thickness 0: cv2 draws outlines of at least 1 pixel')
    bounds = contour if reference is None else reference
    (xmin, ymin), (xmax, ymax) = (fn(bounds, axis=0) for fn in (np.min, np.max))
    xmin, ymin = int(np.floor(xmin)), int(np.floor(ymin))
    xmax, ymax = int(np.ceil(xmax)), int(np.ceil(ymax))
    pts = np.round(contour) if round else contour
    pts = np.asarray(pts, dtype=np.int32).reshape((-1, 2)) - np.array([xmin, ymin], np.int32)
    crop = np.zeros((ymax - ymin + 1, xmax - xmin + 1), dtype=dtype)
    if len(pts):
        if thickness < 0:
            _fill_polygon(crop, pts, val)
        else:
            from ._draw import polylines
            polylines(crop, pts, val, thickness)
    return crop, (xmin, xmax), (ymin, ymax)


def clip_contour_(contour: np.ndarray, size):
    """Clip xy points in place to ``[0, size[1]]`` by ``[0, size[0]]``."""
    np.clip(contour[..., 0], 0, size[1], out=contour[..., 0])
    np.clip(contour[..., 1], 0, size[0], out=contour[..., 1])


def contours2labels(contours, size, rounded: bool = True, clip: bool = True,
                    initial_depth: int = 1, gap: int = 3, dtype='int32',
                    ioa_thresh: float = None, sort_by=None, sort_descending: bool = True,
                    return_indices: bool = False):
    """Contours → label image ``[h, w, c]`` whose channels hold overlapping instances.

    Instance ``i`` gets label ``i + 1``, in the first channel with no label
    within ``gap`` pixels of its box. See :func:`resolve_label_channels` to
    flatten the channels.
    """
    contours_ = contours
    if sort_by is not None:
        indices = np.argsort(sort_by)
        if sort_descending:
            indices = indices[::-1]
        contours_ = (contours[i] for i in indices)
    labels = np.zeros(tuple(size) + (initial_depth,), dtype=dtype)
    lbl = 1
    keep = []
    for idx, contour in enumerate(contours_):
        contour = np.array(contour, dtype=float)
        if rounded:
            contour = np.round(contour)
        if clip:
            clip_contour_(contour, np.array(size) - 1)
        a, (xmin, xmax), (ymin, ymax) = render_contour(contour, val=lbl, dtype=dtype)
        if ioa_thresh is not None:
            m = a > 0
            crp = (labels[ymin:ymin + a.shape[0], xmin:xmin + a.shape[1]] > 0).any(-1)
            ioa = crp[m].sum() / max(m.sum(), 1)
            if ioa > ioa_thresh:
                continue
            keep.append(idx)
        lbl += 1
        s = (labels[max(0, ymin - gap): gap + ymin + a.shape[0],
                    max(0, xmin - gap): gap + xmin + a.shape[1]] > 0).sum((0, 1))
        i = next(i for i in range(labels.shape[2] + 1)
                 if not (i < labels.shape[2] and np.any(s[i])))
        if i >= labels.shape[2]:
            labels = np.concatenate((labels, np.zeros(size, dtype=dtype)[..., None]), axis=-1)
        labels[ymin:ymin + a.shape[0], xmin:xmin + a.shape[1], i] += a
    if return_indices:
        return labels, keep
    return labels


def _cross(ksize) -> np.ndarray:
    """``cv2.getStructuringElement(MORPH_CROSS, ksize)``: the anchor's row and column."""
    kw, kh = ksize
    k = np.zeros((kh, kw), np.uint8)
    k[kh // 2, :] = 1
    k[:, kw // 2] = 1
    return k


def _dilate(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.dilate`` with the kernel's centre as anchor and cv2's default
    border, which never wins a maximum: the largest value under the kernel."""
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    h, w = img.shape
    pad = np.full((h + kh - 1, w + kw - 1), -np.inf)
    pad[ay:ay + h, ax:ax + w] = img
    out = np.full(img.shape, -np.inf)
    for dy, dx in zip(*np.nonzero(kernel)):
        np.maximum(out, pad[dy:dy + h, dx:dx + w], out=out)
    return out


def resolve_label_channels(labels: np.ndarray, method: str = 'dilation', max_iter: int = 999,
                           kernel=(3, 3)) -> np.ndarray:
    """Flatten a channelled label image; overlaps resolved by iterative dilation.

    A pixel of one instance keeps its label; a pixel of several takes, round
    after round, the largest label of its cross-shaped neighbourhood
    (``cv2.getStructuringElement(1, kernel)``) once one is set there.
    """
    if isinstance(kernel, (tuple, list)):
        kernel = _cross(kernel)
    mask_sm = np.sum(labels > 0, axis=-1)
    mask = mask_sm > 1
    if mask.any():
        if method == 'dilation':
            core = mask_sm == 1
            lbl = np.zeros(labels.shape[:2], dtype='float64')
            lbl[core] = labels.max(-1)[core]
            for _ in range(max_iter):
                lbl_prev = np.copy(lbl)
                m = mask & (lbl <= 0)
                if not np.any(m):
                    break
                lbl[m] = _dilate(lbl, np.asarray(kernel))[m]
                if np.allclose(lbl_prev, lbl):
                    break
        else:
            raise ValueError(f'Invalid method: {method}')
    else:
        lbl = labels.max(-1)
    return lbl.astype(labels.dtype)


def contours2properties(contours, *properties, round=True, **kwargs):
    """Region properties (:func:`.misc.labels2properties`) of each contour's
    filled crop, in image coordinates."""
    from .misc import labels2properties
    results = []
    for con in contours:
        m, (xmin, xmax), (ymin, ymax) = render_contour(con, dtype='int32', round=round)
        results += labels2properties(m, *properties, offset=kwargs.pop('offset', (ymin, xmin)),
                                     **kwargs)
    return results


def filter_contours_by_intensity(img, contours, min_intensity=None, max_intensity=200,
                                 aggregate='mean'):
    """Keep mask of the contours whose interior's ``aggregate`` of ``img``
    lies within the bounds."""
    keep = np.ones(len(contours), dtype=bool)
    for idx, con in enumerate(contours):
        m, (xmin, xmax), (ymin, ymax) = render_contour(con, dtype='uint8')
        img_crop = img[ymin:ymin + m.shape[0], xmin:xmin + m.shape[1]]
        m = m[:img_crop.shape[0], :img_crop.shape[1]].astype(bool)
        val = getattr(np, aggregate)(img_crop[m])
        if max_intensity is not None and val > max_intensity:
            keep[idx] = False
        elif min_intensity is not None and val < min_intensity:
            keep[idx] = False
    return keep


def draw_contours(canvas, contours, val=(51, 255, 51), round=True, contour_idx=-1, thickness=2,
                  offset=(0, 0)):
    """``cv2.drawContours(canvas, contours, contour_idx, val, thickness)`` on a
    numpy canvas, changed in place and returned.

    A 2-D canvas with a 3-value ``val`` becomes RGB first (cv2's
    ``GRAY2RGB``: a new array). Float points are rounded (``round``) and
    truncated to integers. ``thickness > 0`` draws each contour's outline,
    ``thickness < 0`` fills all drawn contours as one polygon set (even-odd,
    :func:`_fill_polygons`). ``val`` is a cv2 scalar: a single channel takes
    its first value, missing channels take 0. Lines are cv2's ``LINE_8``.
    """
    contours = np.asarray(contours)
    if canvas.ndim == 2 and isinstance(val, (list, tuple, np.ndarray)) and len(val) == 3:
        canvas = np.repeat(canvas[..., None], 3, -1)
    if contours.dtype.kind == 'f':
        if round:
            contours = contours.round()
        contours = contours.astype(int)
    scalar = list(np.atleast_1d(val)) + [0] * 4
    channels = canvas.shape[2] if canvas.ndim == 3 else 1
    v = scalar[0] if channels == 1 else tuple(scalar[:channels])
    chosen = range(len(contours)) if contour_idx < 0 else [contour_idx]
    polygons = [np.asarray(contours[i], np.int64).reshape(-1, 2) + np.asarray(offset, np.int64)
                for i in chosen]
    if thickness < 0:
        _fill_polygons(canvas, polygons, v)
    else:
        from ._draw import polylines
        for pts in polygons:
            polylines(canvas, pts, v, thickness)
    return canvas


_HSV_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv2rgb_uint8(hsv: np.ndarray, row_lanes: int = 0) -> np.ndarray:
    """``cv2.cvtColor(hsv, COLOR_HSV2RGB)`` of uint8 ``[..., 3]`` triples (hue
    0-179), as cv2 converts one pixel: s and v scaled by ``1 / 255`` in
    float32, the hue by ``6 / 180``, the sector's falling and rising edges
    ``v * (1 - s * h)`` with ``1 - s * h`` fused (one rounding, as cv2's build
    contracts it), and the result times 255 rounded half to even.

    ``row_lanes``: ``hsv`` ``[N, 3]`` is one image row for cv2, whose vector
    loop takes ``row_lanes`` pixels at a time (32 where cv2 dispatches AVX2)
    and converts them back by truncation; the last ``N % row_lanes`` pixels
    take the one-pixel code. 0: every pixel as one pixel alone."""
    f32, one = np.float32, np.float32(1)
    hsv = np.asarray(hsv, np.uint8)
    s = hsv[..., 1].astype(f32) * f32(1 / 255.)
    v = hsv[..., 2].astype(f32) * f32(1 / 255.)
    h = hsv[..., 0].astype(f32) * (f32(6) / f32(180))
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(f32)
    falling = (1. - s.astype(np.float64) * h).astype(f32)          # a fused multiply-add
    rising = (1. - s.astype(np.float64) * (one - h)).astype(f32)
    tab = np.stack([v, v * (one - s), v * falling, v * rising], -1)
    rgb = np.take_along_axis(tab, _HSV_SECTORS[sector % 6], -1)[..., ::-1] * f32(255)
    out = np.rint(rgb)
    if row_lanes:
        vector = len(rgb) - len(rgb) % row_lanes
        out[:vector] = np.trunc(rgb[:vector])
    return np.clip(out, 0, 255).astype(np.uint8)


def _random_rgb(rng: np.random.RandomState) -> tuple:
    """One random overlay colour: hue, saturation and value drawn in that order."""
    hsv = np.uint8([rng.randint(0, 180), rng.randint(60, 256), rng.randint(128, 256)])
    return tuple(int(c) for c in hsv2rgb_uint8(hsv))


def _paint(canvas, contour, rgb, size, thickness, rounded, clip):
    contour = np.array(contour, dtype=float)
    if rounded:
        contour = np.round(contour)
    if clip:
        clip_contour_(contour, np.array(size) - 1)
    a, (xmin, _), (ymin, _) = render_contour(contour, val=1, dtype='uint8', thickness=thickness)
    region = canvas[ymin:ymin + a.shape[0], xmin:xmin + a.shape[1]]
    m = (a > 0)[:region.shape[0], :region.shape[1]]
    region[m] = tuple(rgb) + (255,)


def contours2overlay(contours, size, colors=None, thickness=-1, rounded=True, clip=True,
                     seed=None, processes: int = None) -> np.ndarray:
    """RGBA uint8 overlay ``[*size, 4]`` of filled contours, later ones on top.

    Args:
        colors: Optional per-instance RGB(A) uint8 colours ``[n, 3|4]``
            (cycled); else random HSV colours from ``RandomState(seed)``, as
            the JAX package draws them.
        processes: More than 1 (and more than 256 contours, no ``colors``):
            the canvas lies in shared memory and chunks of contours render in
            that many worker processes, each contour in a colour from a seed
            of its own.
    """
    if colors is None and processes and processes > 1 and contours is not None \
            and len(contours) > 256:
        return _contours2overlay_mp(contours, size, thickness=thickness, rounded=rounded,
                                    clip=clip, seed=seed, processes=processes)
    rng = np.random.RandomState(seed)
    overlay = np.zeros(tuple(size) + (4,), dtype=np.uint8)
    if contours is None or len(contours) == 0:
        return overlay
    for ci, contour in enumerate(contours):
        if colors is not None:
            rgb = tuple(int(c) for c in np.asarray(colors[ci % len(colors)], np.uint8)[:3])
        else:
            rgb = _random_rgb(rng)
        _paint(overlay, contour, rgb, size, thickness, rounded, clip)
    return overlay


_MP_OVERLAY = {}


def _overlay_worker_init(shm_name, shape):
    from multiprocessing import shared_memory
    shm = shared_memory.SharedMemory(name=shm_name)
    _MP_OVERLAY['shm'] = shm  # kept open for the worker's lifetime
    _MP_OVERLAY['canvas'] = np.ndarray(shape, dtype=np.uint8, buffer=shm.buf)


def _overlay_worker(args):
    chunk, seeds, size, thickness, rounded, clip = args
    canvas = _MP_OVERLAY['canvas']
    for contour, seed_i in zip(chunk, seeds):
        _paint(canvas, contour, _random_rgb(np.random.RandomState(seed_i)), size, thickness,
               rounded, clip)
    return len(chunk)


def _contours2overlay_mp(contours, size, thickness=-1, rounded=True, clip=True, seed=None,
                         processes=4) -> np.ndarray:
    """The overlay rendered by ``processes`` workers into a shared-memory
    canvas, in chunks of contours; where instances overlap, the chunk painted
    last wins."""
    from multiprocessing import Pool, shared_memory
    shape = tuple(size) + (4,)
    shm = shared_memory.SharedMemory(create=True, size=int(np.prod(shape)))
    try:
        canvas = np.ndarray(shape, dtype=np.uint8, buffer=shm.buf)
        canvas[:] = 0
        seeds = np.random.RandomState(seed).randint(0, 2 ** 31, size=len(contours))
        n_chunks = min(processes * 4, max(len(contours) // 64, 1))
        jobs = [([contours[i] for i in ids], seeds[ids], size, thickness, rounded, clip)
                for ids in np.array_split(np.arange(len(contours)), n_chunks) if len(ids)]
        with Pool(processes, initializer=_overlay_worker_init,
                  initargs=(shm.name, shape)) as pool:
            pool.map(_overlay_worker, jobs)
        return canvas.copy()
    finally:
        shm.close()
        shm.unlink()


class CPNTargetGenerator:
    """Training targets of one label image.

    ``feed(labels)`` filters instances, extracts contours (which may flag
    fragmented instances), computes the distance transform and the fg/bg
    masking. The derived quantities (Fourier coefficients, locations,
    sampled and resampled contours) are built on demand by the ``_stage_*``
    methods behind one memo, so each runs at most once per fed image.
    """

    def __init__(self, samples: int, order: int, random_sampling: bool = True,
                 remove_partials: bool = False, min_fg_dist: float = .75, max_bg_dist: float = .5,
                 flag_fragmented: bool = True, flag_fragmented_constant: int = -1,
                 rng: np.random.RandomState = None):
        self.samples = samples
        self.order = order
        self.random_sampling = random_sampling
        self.remove_partials = remove_partials
        self.min_fg_dist = min_fg_dist
        self.max_bg_dist = max_bg_dist
        self.flag_fragmented = flag_fragmented
        self.flag_fragmented_constant = flag_fragmented_constant
        self.rng = rng or np.random
        self.labels = self.labels_red = self.distances = None
        self._memo = {}

    def _stage(self, name: str):
        if name not in self._memo:
            self._memo[name] = getattr(self, f'_stage_{name}')()
        return self._memo[name]

    def feed(self, labels: np.ndarray, border: int = 1, min_area: int = 1, max_area: int = None,
             **kwargs):
        """Feed a label image (it may be modified in place)."""
        self._memo.clear()
        self.labels = labels if labels.ndim == 3 else labels[..., None]
        filter_instances_(self.labels, partials=self.remove_partials, partials_border=border,
                          min_area=min_area, max_area=max_area, constant=-1, continuous=True)
        # contour extraction may flag fragmented instances in self.labels, so
        # it runs before the distance transform
        self._stage('contours')
        self.distances, self.labels_red = labels2distances(self.labels, **kwargs)
        mask_labels_by_distance_(self.labels_red, self.distances, self.max_bg_dist, self.min_fg_dist)

    def _stage_sampling(self):
        if self.random_sampling:
            return np.sort(self.rng.uniform(0., 1., self.samples))
        return np.linspace(0., 1., self.samples)

    def _stage_contours(self):
        return labels2contours(self.labels, flag_fragmented_inplace=self.flag_fragmented,
                               constant=self.flag_fragmented_constant, raise_fragmented=False)

    def _stage_efd(self):
        return contours2fourier(self._stage('contours'), order=self.order)

    def _stage_sampled_contours(self):
        fourier, locations = self._stage('efd')
        return fourier2contour(fourier, locations, samples=self.samples, sampling=self.sampling)

    def _stage_resampled_contours(self):
        contours = self._stage('contours')
        num = int(max(contours.keys(), default=0))
        out = np.zeros((num, self.samples, 2))
        for label, contour in contours.items():
            out[label - 1] = resample_contours(contour.reshape(-1, 2), self.samples)
        return out

    @property
    def reduced_labels(self) -> np.ndarray:
        if self.flag_fragmented:
            self._stage('contours')   # may drop fragmented instances first
        return self.labels_red.max(2)

    @property
    def sampling(self) -> np.ndarray:
        return self._stage('sampling')

    @property
    def contours(self) -> dict:
        return self._stage('contours')

    @property
    def fourier(self) -> np.ndarray:
        return self._stage('efd')[0]

    @property
    def locations(self) -> np.ndarray:
        return self._stage('efd')[1]

    @property
    def sampled_contours(self) -> np.ndarray:
        """``[num_contours, samples, 2]`` decoded from the EFD targets."""
        return self._stage('sampled_contours')

    @property
    def resampled_contours(self) -> np.ndarray:
        """The ground-truth contours resampled at equal arc length (hires targets)."""
        return self._stage('resampled_contours')

    @property
    def sampled_sizes(self) -> np.ndarray:
        """``[num_contours, 2]`` extent of each sampled contour."""
        c = self.sampled_contours
        return c.max(1) - c.min(1)
