"""cv2's drawing and filtering primitives of the toy data and the augmentations, in numpy.

Each function gives what the cv2 call it names gives (OpenCV 5.0.0), pixel
for pixel or bit for bit, for the arguments the data modules pass: 8-connected
filled shapes with ``shift=0`` on a single-channel image, ``GaussianBlur`` of
a float32 image with ``BORDER_REFLECT_101``, and ``remap`` with float32 maps
(``INTER_LINEAR`` with ``BORDER_REFLECT``, ``INTER_NEAREST`` with
``BORDER_CONSTANT``).

* ``circle`` is cv2's integer midpoint circle (``Circle``), each row pair a
  horizontal span;
* ``ellipse`` goes through ``ellipse2Poly`` (cv2's float table of sines in
  whole degrees) and ``FillConvexPoly`` in 16.16 fixed point, whose outline
  is drawn by ``Line2``;
* ``rectangle`` fills the box between the two corners;
* ``fill_poly`` is ``cv2.fillPoly`` / ``cv2.drawContours(..., -1)``: the
  port's polygon fill (:func:`.cpn._fill_polygon`), which clips lines and
  rows that leave the image as cv2 does;
* ``line`` is ``cv2.line(..., LINE_8)`` of integer points (``ThickLine``):
  thickness 1 is the ``LineIterator``'s 8-connected line between the end
  points ``clipLine`` leaves; a thicker line is first clipped by
  ``clipLine`` to the image widened by the thickness on every side, then
  drawn as a quad about the clipped segment in 16.16 fixed point (its corners offset by ``cvRound`` of the normal scaled
  to half the thickness, in double), filled by ``FillConvexPoly``, with a
  filled ``circle`` of radius ``(thickness + 1) // 2`` at each end, which
  rounds the joins; ``polylines`` draws a contour's segments so, the last
  point joined to the first, as ``cv2.drawContours(..., thickness > 0)``;
* ``gaussian_blur`` is separable, with cv2's kernel (computed in double,
  cast to float32) and the float32 order of summation of cv2's row and
  column filters, whose vector loops (AVX2 on x86-64) fuse each multiply-add
  and whose scalar tails do not;
* ``remap_linear`` interpolates in float32 at the map's coordinates, as
  cv2 5 does for 1, 3 and 4 channels (other counts keep its 1/32-px
  table); ``remap_nearest`` rounds the
  coordinates half to even, as cv2's ``saturate_cast`` does.
"""
import math

import numpy as np

from .cpn import _fill_polygon, _line_pixels, clip_line

__all__ = ['circle', 'ellipse', 'rectangle', 'fill_poly', 'line', 'polylines', 'gaussian_kernel', 'gaussian_blur',
           'remap_linear', 'remap_nearest', 'SIN_TABLE']

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
INTER_BITS = 5                  # the older remap's 1/32-px grid
INTER_TAB_SIZE = 1 << INTER_BITS

# cv2's ``SinTable``: sin of 0..450 whole degrees, written to 7 decimals, as float32
SIN_TABLE = np.array([float(f'{math.sin(math.radians(i)):.7f}') for i in range(451)],
                     np.float32)


def _hline(img, y, x0, x1, val):
    h, w = img.shape[:2]
    if 0 <= y < h and x1 >= 0 and x0 < w:
        img[y, max(x0, 0):min(x1, w - 1) + 1] = val


def circle(img: np.ndarray, center, radius: int, val):
    """``cv2.circle(img, center, radius, val, -1)``: a filled midpoint circle."""
    cx, cy = (int(v) for v in center)
    err, dx, dy, plus, minus = 0, int(radius), 0, 1, 2 * int(radius) - 1
    while dx >= dy:
        for y, half in ((cy - dy, dx), (cy + dy, dx), (cy - dx, dy), (cy + dx, dy)):
            _hline(img, y, cx - half, cx + half, val)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2
    return img


def rectangle(img: np.ndarray, pt1, pt2, val):
    """``cv2.rectangle(img, pt1, pt2, val, -1)``: every pixel of the closed box, clipped."""
    (x0, y0), (x1, y1) = (tuple(int(v) for v in p) for p in (pt1, pt2))
    x0, x1 = min(x0, x1), max(x0, x1)
    y0, y1 = min(y0, y1), max(y0, y1)
    h, w = img.shape[:2]
    if x1 >= 0 and y1 >= 0 and x0 < w and y0 < h:
        img[max(y0, 0):min(y1, h - 1) + 1, max(x0, 0):min(x1, w - 1) + 1] = val
    return img


def _ellipse_points(center, axes, angle: int, delta: int):
    """``ellipse2Poly`` of a full ellipse in fixed point (``EllipseEx``): the
    float sines of cv2's table, the points rounded and consecutive repeats dropped."""
    angle = int(angle)
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    alpha = float(SIN_TABLE[450 - angle])       # cos
    beta = float(SIN_TABLE[angle])              # sin
    cx, cy = (float(int(v) << XY_SHIFT) for v in center)
    aw, ah = (float(abs(int(v)) << XY_SHIFT) for v in axes)
    pts = []
    for i in range(0, 360 + delta, delta):
        a = min(i, 360)
        x = aw * float(SIN_TABLE[450 - a])
        y = ah * float(SIN_TABLE[a])
        px, py = cx + x * alpha - y * beta, cy + x * beta + y * alpha
        p = (_round(px), _round(py))
        if not pts or p != pts[-1]:
            pts.append(p)
    if len(pts) == 1:
        pts = [(int(center[0]) << XY_SHIFT, int(center[1]) << XY_SHIFT)] * 2
    return pts


def _round(v: float) -> int:
    """``cvRound``: to nearest, ties to even."""
    return int(np.rint(v))


def _line2(img, p1, p2, val):
    """cv2's ``Line2``: an 8-connected line between 16.16 fixed-point points, clipped."""
    h, w = img.shape[:2]
    (x1, y1), (x2, y2), inside = clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2)
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = XY_ONE, _cdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = _cdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    half = XY_ONE >> 1
    xs, ys = [(x2 + half) >> XY_SHIFT], [(y2 + half) >> XY_SHIFT]
    k = np.arange(ecount + 1, dtype=np.int64) if ecount >= 0 else np.zeros(0, np.int64)
    if ax > ay:
        xs.extend((x1 >> XY_SHIFT) + k)
        ys.extend((y1 + k * y_step) >> XY_SHIFT)
    else:
        xs.extend((x1 + k * x_step) >> XY_SHIFT)
        ys.extend((y1 >> XY_SHIFT) + k)
    xs, ys = np.asarray(xs, np.int64), np.asarray(ys, np.int64)
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[inside], xs[inside]] = val


def _cdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _fill_convex(img, pts, val):
    """cv2's ``FillConvexPoly`` of 16.16 fixed-point points (``shift = XY_SHIFT``,
    8-connected): the outline by ``Line2``, then one span a row between the
    two chains that walk down from the topmost point."""
    h, w = img.shape[:2]
    n = len(pts)
    delta = XY_ONE >> 1
    p0 = pts[-1]
    for p in pts:
        _line2(img, p0, p, val)
        p0 = p
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    imin = int(np.argmin(ys))           # the first of the topmost points
    xmin, xmax = (min(xs) + delta) >> XY_SHIFT, (max(xs) + delta) >> XY_SHIFT
    ymin, ymax = (min(ys) + delta) >> XY_SHIFT, (max(ys) + delta) >> XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [dict(idx=imin, di=1, x=-XY_ONE, dx=0, ye=ymin),
            dict(idx=imin, di=n - 1, x=-XY_ONE, dx=0, ye=ymin)]
    edges = n
    y = ymin
    while True:
        for e in edge:
            if y >= e['ye']:
                idx0, di = e['idx'], e['di']
                idx = (idx0 + di) % n
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (pts[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        xs_, xe = pts[idx0][0], pts[idx][0]
                        e['ye'] = ty
                        e['dx'] = _cdiv((xe - xs_) * 2 + (ty - y), 2 * (ty - y))
                        e['x'] = xs_
                        e['idx'] = idx
                        break
                    idx0 = idx
                    idx = (idx + di) % n
        if edges < 0:
            break
        if y >= 0:
            left, right = (edge[1], edge[0]) if edge[0]['x'] > edge[1]['x'] else (edge[0], edge[1])
            _hline(img, y, (left['x'] + delta) >> XY_SHIFT, (right['x'] + delta) >> XY_SHIFT, val)
        edge[0]['x'] += edge[0]['dx']
        edge[1]['x'] += edge[1]['dx']
        y += 1
        if y > ymax:
            break


def ellipse(img: np.ndarray, center, axes, angle, val):
    """``cv2.ellipse(img, center, axes, angle, 0, 360, val, -1)``: a filled ellipse."""
    ext = (max(abs(int(axes[0])), abs(int(axes[1]))) << XY_SHIFT) + (XY_ONE >> 1) >> XY_SHIFT
    delta = 90 if ext < 3 else 30 if ext < 10 else 18 if ext < 15 else 5
    _fill_convex(img, _ellipse_points(center, axes, _round(float(angle)), delta), val)
    return img


def fill_poly(img: np.ndarray, pts, val):
    """``cv2.fillPoly(img, [pts], val)`` (also ``cv2.drawContours(img, [pts], 0, val,
    -1)``) of one polygon of integer points, which may leave the image."""
    pts = np.asarray(pts, np.int64).reshape(-1, 2)
    if len(pts):
        _fill_polygon(img, pts, val)
    return img


def _line8(img, p1, p2, val):
    """cv2's ``Line`` (``LineIterator``, 8-connected, left to right), clipped."""
    h, w = img.shape[:2]
    (x1, y1), (x2, y2) = p1, p2
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        (x1, y1), (x2, y2), inside = clip_line(w, h, p1, p2)
        if not inside:
            return
    xs, ys = _line_pixels(x1, y1, x2, y2)
    img[ys, xs] = val


def line(img: np.ndarray, pt1, pt2, val, thickness: int = 1):
    """``cv2.line(img, pt1, pt2, val, thickness)`` (``LINE_8``, no shift) of integer points."""
    (x0, y0), (x1, y1) = (tuple(int(v) for v in p) for p in (pt1, pt2))
    if thickness <= 1:
        _line8(img, (x0, y0), (x1, y1), val)
        return img
    half = thickness << (XY_SHIFT - 1)
    # the segment first clipped to the image widened by the thickness on every side
    h, w = img.shape[:2]
    m = thickness
    (c0x, c0y), (c1x, c1y), inside = clip_line(w + 2 * m, h + 2 * m, (x0 + m, y0 + m),
                                               (x1 + m, y1 + m))
    p0x, p0y = (c0x - m) << XY_SHIFT, (c0y - m) << XY_SHIFT
    p1x, p1y = (c1x - m) << XY_SHIFT, (c1y - m) << XY_SHIFT
    dx, dy = (p0x - p1x) / XY_ONE, (p1y - p0y) / XY_ONE
    r = dx * dx + dy * dy
    if inside and abs(r) > np.finfo(np.float64).eps:
        r = (half + (thickness & 1) * XY_ONE * 0.5) / math.sqrt(r)
        ox, oy = _round(dy * r), _round(dx * r)
        _fill_convex(img, [(p0x + ox, p0y + oy), (p0x - ox, p0y - oy),
                           (p1x - ox, p1y - oy), (p1x + ox, p1y + oy)], val)
    radius = (half + (XY_ONE >> 1)) >> XY_SHIFT
    circle(img, (x0, y0), radius, val)
    circle(img, (x1, y1), radius, val)
    return img


def polylines(img: np.ndarray, pts, val, thickness: int = 1):
    """The outline of one closed contour of integer points, as
    ``cv2.drawContours(img, [pts], 0, val, thickness)`` draws it for
    ``thickness >= 1``: every segment, the last point joined to the first."""
    pts = np.asarray(pts, np.int64).reshape(-1, 2).tolist()
    for j, p in enumerate(pts):
        line(img, p, pts[(j + 1) % len(pts)], val, thickness)
    return img


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, sigma, CV_32F)``: computed in double, cast to float32."""
    if sigma <= 0:
        sigma = ((ksize - 1) * 0.5 - 1) * 0.3 + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    t = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (t / t.sum()).astype(np.float32)


def _reflect101(n: int, pad: int) -> np.ndarray:
    """Source indices of ``BORDER_REFLECT_101`` for ``-pad .. n + pad - 1``."""
    i = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    i = np.abs(i) % period
    return np.where(i >= n, period - i, i)


_LOW29, _TIE = np.int64((1 << 29) - 1), np.int64(1 << 28)   # a float32 midpoint's low bits
_EXP, _F32_NORMAL = np.int64(0x7ff << 52), np.int64((1023 - 126) << 52)   # float64 bits of 2^-126


def _fma(a, b, c):
    """float32 ``fma(a, b, c)``: ``a * b + c`` rounded once. The product is
    exact in float64; the float64 sum rounds, and so can the cast after it,
    but only where the sum lands on a midpoint of float32 (low 29 bits
    ``1 << 28``, or below float32's normal range). There the sum's exact
    error (TwoSum) says on which side the exact value lies."""
    s = np.multiply(a, b, dtype=np.float64)
    s += c
    r = s.astype(np.float32)
    bits = s.view(np.int64)
    low = bits & _LOW29
    tie = low == _TIE
    tiny = np.bitwise_and(bits, _EXP, out=low) < _F32_NORMAL
    if tiny.any():
        tie |= tiny & (s != 0)
    if not tie.any():
        return r
    i = np.nonzero(tie)
    ps = np.broadcast_to(a, s.shape)[i].astype(np.float64) * np.broadcast_to(b, s.shape)[i]
    cs = np.broadcast_to(c, s.shape)[i].astype(np.float64)
    ss = s[i]
    bv = ss - ps
    err = (ps - (ss - bv)) + (cs - bv)
    ri = r[i]
    r64 = ri.astype(np.float64)
    beyond = np.nextafter(ri, np.where(ss > r64, np.float32(np.inf), np.float32(-np.inf)))
    away = (2 * ss == r64 + beyond.astype(np.float64)) & (np.sign(err) == np.sign(ss - r64))
    r[i] = np.where(away & (ss != r64), beyond, ri)
    return r


def _taps(x: np.ndarray, c: int, axis: int):
    """``tap(j)``: ``x`` shifted by ``j`` along ``axis`` over a ``BORDER_REFLECT_101`` border."""
    src = np.take(x, _reflect101(x.shape[axis], c), axis=axis)
    n = x.shape[axis]
    return lambda j: np.take(src, np.arange(c + j, c + j + n), axis=axis)


def _vector_then_scalar(fused: np.ndarray, plain: np.ndarray, lanes: int) -> np.ndarray:
    """cv2's vector loop takes the first ``width - width % lanes`` columns
    (its multiply-adds fused); its scalar tail the rest (multiply, then add)."""
    w = fused.shape[1]
    fused[:, w - w % lanes:] = plain[:, w - w % lanes:]
    return fused


def _row_pass(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    """cv2's float32 row filter. 5 taps (``SymmRowSmallFilter``): the vector
    loop ``fma(S[-2] + S[2], k2, fma(S[0], k0, (S[-1] + S[1]) k1))`` in pairs
    of columns, the scalar tail ``S[0] k0 + (S[-1] + S[1]) k1 + (S[-2] + S[2]) k2``;
    else (``RowFilter``) the taps from left to right, each fused into the sum
    in the vector loop (4 columns at a time); its scalar tail adds taps 1 to
    ``4 floor((n - 1) / 4)`` and fuses the rest (the compiler's unrolling).
    Bit for bit for 5 or more taps."""
    c = len(k) // 2
    tap = _taps(x, c, 1)
    if len(k) == 1:
        return x * k[0]
    if len(k) == 5:
        inner, outer = tap(-1) + tap(1), tap(-2) + tap(2)
        fused = _fma(outer, k[4], _fma(tap(0), k[2], inner * k[3]))
        return _vector_then_scalar(fused, tap(0) * k[2] + inner * k[3] + outer * k[4], 2)
    fused = tap(-c) * k[0]
    plain = fused.copy()
    unrolled = 1 + 4 * ((len(k) - 1) // 4)
    for j in range(1, len(k)):
        fused = _fma(tap(j - c), k[j], fused)
        if j < unrolled:
            plain += tap(j - c) * k[j]
        else:
            plain = _fma(tap(j - c), k[j], plain)
    return _vector_then_scalar(fused, plain, 4)


def _column_pass(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    """cv2's float32 column filter of a symmetric kernel (``SymmColumnFilter``):
    ``S[0] k0``, then ``S[-j] + S[j]`` times ``kj`` for j = 1, 2, ..., fused
    into the sum in the vector loop (8 columns at a time) and added in its tail."""
    c = len(k) // 2
    tap = _taps(x, c, 0)
    fused = tap(0) * k[c]
    plain = fused.copy()
    for j in range(1, c + 1):
        fused = _fma(tap(-j) + tap(j), k[c + j], fused)
        plain += (tap(-j) + tap(j)) * k[c + j]
    return _vector_then_scalar(fused, plain, 8)


def gaussian_blur(image: np.ndarray, ksize, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(image, ksize, sigma)`` of a float32 image of one
    channel (``BORDER_REFLECT_101``), of at least two rows and columns.
    ``ksize (0, 0)`` takes cv2's size for float images, ``cvRound(sigma * 8 +
    1) | 1``. Bit for bit for kernels of 5 or more taps (3 taps, a sigma
    below 0.3125, sum in another order)."""
    image = np.asarray(image, np.float32)
    kx, ky = ksize
    if kx <= 0:
        kx = ky = _round(sigma * 4 * 2 + 1) | 1
    return _column_pass(_row_pass(image, gaussian_kernel(kx, sigma)), gaussian_kernel(ky, sigma))


def _reflect(i: np.ndarray, n: int) -> np.ndarray:
    """``BORDER_REFLECT`` (``fedcba|abcdefgh|hgfedcb``) indices into ``[0, n)``."""
    if n == 1:
        return np.zeros_like(i)
    period = 2 * n
    i = np.mod(i, period)
    return np.where(i >= n, period - 1 - i, i)


def _table_remap(image, map_x, map_y):
    """cv2's older bilinear remap, which it keeps for 2 and more than 4
    channels: the map rounded to 1/32 px, the four weights from its float
    table, summed ``p00 w0 + p01 w1 + p10 w2 + p11 w3`` in that order."""
    h, w = image.shape[:2]
    X = np.rint(map_x * np.float32(INTER_TAB_SIZE)).astype(np.int64)
    Y = np.rint(map_y * np.float32(INTER_TAB_SIZE)).astype(np.int64)
    t = np.arange(INTER_TAB_SIZE, dtype=np.float32) * np.float32(1. / INTER_TAB_SIZE)
    coef = np.stack([np.float32(1) - t, t], -1)
    table = (coef[:, None, :, None] * coef[None, :, None, :]).reshape(-1, 4)
    wt = table[(Y & (INTER_TAB_SIZE - 1)) * INTER_TAB_SIZE + (X & (INTER_TAB_SIZE - 1))][:, :, None]
    sx, sy = X >> INTER_BITS, Y >> INTER_BITS
    x0, x1 = _reflect(sx, w), _reflect(sx + 1, w)
    y0, y1 = _reflect(sy, h), _reflect(sy + 1, h)
    out = image[y0, x0] * wt[..., 0]
    out += image[y0, x1] * wt[..., 1]
    out += image[y1, x0] * wt[..., 2]
    out += image[y1, x1] * wt[..., 3]
    return out


def remap_linear(image: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """``cv2.remap(image, map_x, map_y, INTER_LINEAR, borderMode=BORDER_REFLECT)``
    of a float32 image ``[h, w]`` or ``[h, w, c]`` with float32 maps.

    For 1, 3 and 4 channels cv2 5 interpolates in float32 at the map's own
    coordinates: ``a = p00 + t (p01 - p00)``, ``b = p10 + t (p11 - p10)``,
    then ``a + u (b - a)``, each multiply-add fused, where ``t`` and ``u``
    are the fractions of x and y and the four neighbours are read through
    ``BORDER_REFLECT`` (``fedcba|abcdefgh|hgfedcb``); other channel counts
    take its 1/32-px table (:func:`_table_remap`)."""
    image = np.asarray(image, np.float32)
    h, w = image.shape[:2]
    map_x, map_y = np.asarray(map_x, np.float32), np.asarray(map_y, np.float32)
    if image.ndim == 3 and image.shape[2] not in (1, 3, 4):
        return _table_remap(image, map_x, map_y)
    fx, fy = np.floor(map_x), np.floor(map_y)
    t, u = map_x - fx, map_y - fy
    if image.ndim == 3:
        t, u = t[..., None], u[..., None]
    sx, sy = fx.astype(np.int64), fy.astype(np.int64)
    x0, x1 = _reflect(sx, w), _reflect(sx + 1, w)
    y0, y1 = _reflect(sy, h), _reflect(sy + 1, h)
    p00, p01, p10, p11 = image[y0, x0], image[y0, x1], image[y1, x0], image[y1, x1]
    a = _fma(t, p01 - p00, p00)
    b = _fma(t, p11 - p10, p10)
    return _fma(u, b - a, a)


def remap_nearest(image: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """``cv2.remap(image, map_x, map_y, INTER_NEAREST, borderMode=BORDER_CONSTANT,
    borderValue=0)`` with float32 maps: the coordinates rounded half to even."""
    h, w = image.shape[:2]
    sx = np.rint(np.asarray(map_x, np.float32)).astype(np.int64)
    sy = np.rint(np.asarray(map_y, np.float32)).astype(np.int64)
    inside = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    out = np.zeros(sx.shape + image.shape[2:], image.dtype)
    out[inside] = image[sy[inside], sx[inside]]
    return out
