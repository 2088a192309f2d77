"""Port parity: the toy data without cv2 (``celldetection_tpu_torch.data.toydata``).

The port draws with numpy versions of cv2's primitives (``data/_draw.py``);
the JAX package calls cv2 itself. Everything here is held exactly (pixel
for pixel, bit for bit):

* each primitive against the cv2 call it replaces, on random arguments
  that also leave the image (cv2's clipping): ``circle``, ``ellipse``
  (and cv2's table of sines, read back through ``ellipse2Poly``),
  ``rectangle``, ``fillPoly`` and ``drawContours(..., -1)``;
* ``GaussianBlur`` of float32 images of at least two rows and columns,
  ``(5, 5), 1.5`` and ``(0, 0), sigma``, at widths on and off cv2's
  vector loops (its fused multiply-adds) and scalar tails;
* the shape painters, ``random_geometric_objects`` (several seeds, sizes
  and ``channels`` 1 and 3), ``random_geometric_shapes`` and
  ``synthetic_cells`` against the JAX package on the same seeds.
"""
import cv2
import numpy as np
import pytest

from celldetection_tpu.data import toydata as jtoy
from celldetection_tpu_torch.data import _draw
from celldetection_tpu_torch.data import toydata as ttoy
from test_torch_port_cpn import one_torch_thread  # noqa: F401  (pytestmark)

pytestmark = pytest.mark.usefixtures('one_torch_thread')

# cv2 5.0.0's float32 blur and bilinear remap, which ``data/_draw.py`` copies
# bit for bit, fuse their multiply-adds in vector loops of AVX2's widths (2, 4
# and 8 columns) and leave the scalar tails unfused; where cv2 does not
# dispatch AVX2 (another CPU), its sums round otherwise.
cv2_avx2 = pytest.mark.skipif(not cv2.checkHardwareSupport(11),       # cv::CPU_AVX2
                              reason='cv2 dispatches no AVX2 on this CPU: its float32 blur '
                                     'and remap round in another order')

H, W = 48, 57


def _cases(seed, n=400):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        yield rng, (int(rng.randint(-12, W + 12)), int(rng.randint(-12, H + 12)))


def _draw_pair(cv2_call, port_call):
    a = np.zeros((H, W), np.uint8)
    b = a.copy()
    cv2_call(a)
    port_call(b)
    return a, b


@pytest.mark.parametrize('primitive', ['circle', 'ellipse', 'rectangle', 'fill_poly',
                                       'draw_contours'])
def test_primitive_matches_cv2(primitive):
    for i, (rng, c) in enumerate(_cases(['circle', 'ellipse', 'rectangle', 'fill_poly',
                                         'draw_contours'].index(primitive))):
        if primitive == 'circle':
            r = int(rng.randint(0, 40))
            a, b = _draw_pair(lambda m: cv2.circle(m, c, r, 1, -1),
                              lambda m: _draw.circle(m, c, r, 1))
        elif primitive == 'ellipse':
            axes = (int(rng.randint(0, 40)), int(rng.randint(0, 40)))
            angle = float(rng.randint(-30, 400))
            a, b = _draw_pair(lambda m: cv2.ellipse(m, c, axes, angle, 0, 360, 1, -1),
                              lambda m: _draw.ellipse(m, c, axes, angle, 1))
        elif primitive == 'rectangle':
            d = rng.randint(-40, 40, 2)
            p2 = (c[0] + int(d[0]), c[1] + int(d[1]))
            a, b = _draw_pair(lambda m: cv2.rectangle(m, c, p2, 1, -1),
                              lambda m: _draw.rectangle(m, c, p2, 1))
        else:
            pts = (rng.rand(rng.randint(3, 9), 2) * [W + 40, H + 40] - 20).astype(np.int32)
            if primitive == 'fill_poly':
                a, b = _draw_pair(lambda m: cv2.fillPoly(m, [pts], 1),
                                  lambda m: _draw.fill_poly(m, pts, 1))
            else:
                a, b = _draw_pair(lambda m: cv2.drawContours(m, [pts.reshape(-1, 1, 2)], 0, 1, -1),
                                  lambda m: _draw.fill_poly(m, pts, 1))
        assert np.array_equal(a, b), (primitive, i)


def test_sin_table_matches_cv2():
    # ellipse2Poly's points of an ellipse with axes 2^30 at angle 0 are cv2's
    # SinTable times 2^30, exact for a float32 table
    pts = np.array(cv2.ellipse2Poly((0, 0), (2 ** 30, 2 ** 30), 0, 0, 360, 1))
    want = np.stack([np.round(2 ** 30 * _draw.SIN_TABLE[450 - np.arange(361)].astype(float)),
                     np.round(2 ** 30 * _draw.SIN_TABLE[:361].astype(float))], 1)
    np.testing.assert_array_equal(pts, want)


@pytest.mark.parametrize('ksize, sigma', [((5, 5), 1.5), ((0, 0), 6.), ((0, 0), 3.),
                                          ((0, 0), 0.6)])
@cv2_avx2
def test_gaussian_blur_matches_cv2_bit_for_bit(ksize, sigma):
    rng = np.random.RandomState(0)
    n = ksize[0] or (int(np.rint(sigma * 8 + 1)) | 1)
    np.testing.assert_array_equal(_draw.gaussian_kernel(n, sigma),
                                  cv2.getGaussianKernel(n, sigma, cv2.CV_32F).ravel())
    for shape in ((64, 80), (37, 23), (5, 3), (17, 9), (2, 31), (120, 4)):
        x = (rng.rand(*shape) * 2 - 1).astype(np.float32)
        np.testing.assert_array_equal(_draw.gaussian_blur(x, ksize, sigma),
                                      cv2.GaussianBlur(x, ksize, sigma), err_msg=str(shape))


@pytest.mark.parametrize('painter', ['random_circle', 'random_ellipse', 'random_rectangle',
                                     'random_triangle'])
def test_shape_painters_match_jax(painter):
    for seed in range(40):
        out = []
        for lib in (jtoy, ttoy):
            image = np.full((64, 72, 3), 255, np.uint8)
            mask = np.zeros((64, 72), np.uint8)
            rng = np.random.RandomState(seed)
            xy = rng.randint(0, 72), rng.randint(0, 64)
            out.append(getattr(lib, painter)(image, mask, *xy, [10, 20, 30], rng=rng)
                       + (rng.rand(),))
        (ji, jmk, jr), (ti, tmk, tr) = out
        assert np.array_equal(ji, ti) and np.array_equal(jmk, tmk) and jr == tr, seed


@cv2_avx2
@pytest.mark.parametrize('seed', range(6))
def test_random_geometric_objects_matches_jax(seed):
    h, w = (96, 128, 256)[seed % 3], (128, 121, 256)[seed % 3]
    for channels in (1, 3):
        kw = dict(num=(24, 12)[seed % 2], radius=((8, 24), (6, 14))[seed % 2], seed=seed,
                  channels=channels)
        ji, jl = jtoy.random_geometric_objects(h, w, **kw)
        ti, tl = ttoy.random_geometric_objects(h, w, **kw)
        assert ti.dtype == ji.dtype and tl.dtype == jl.dtype and tl.shape == jl.shape
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize('seed, size', [(0, (256, 256)), (1, (128, 160)), (2, (139, 97)),
                                        (3, (40, 40))])
def test_random_geometric_shapes_matches_jax(seed, size):
    want = jtoy.random_geometric_shapes(*size, seed=seed)
    got = ttoy.random_geometric_shapes(*size, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@cv2_avx2
def test_synthetic_cells_matches_jax():
    for (ji, jl), (ti, tl) in zip(jtoy.synthetic_cells(3, 64, 64, seed=7, num=6, radius=(5, 9)),
                                  ttoy.synthetic_cells(3, 64, 64, seed=7, num=6, radius=(5, 9))):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)


def test_render_contour_clips_to_a_smaller_reference_as_the_jax_package():
    """``render_contour`` with a ``reference`` box that cuts the contour: the
    crop is cv2's ``drawContours(offset=...)``, lines and rows clipped."""
    from celldetection_tpu.data import cpn as jcpn
    from celldetection_tpu_torch.data import cpn as tcpn
    rng = np.random.RandomState(5)
    for _ in range(60):
        contour = rng.rand(rng.randint(3, 12), 2) * 40
        reference = np.sort(rng.rand(2, 2) * 40, 0) + [[0, 0], [3, 3]]
        want = jcpn.render_contour(contour, val=3, reference=reference)
        got = tcpn.render_contour(contour, val=3, reference=reference)
        assert got[1:] == want[1:]
        np.testing.assert_array_equal(got[0], want[0])


def test_fma_rounds_once():
    """``_fma`` against the exact value (rationals), rounded to the nearest
    float32, ties to even: on products ``1 + 2^-11 k + 2^-24 j`` (a float32
    midpoint) plus a small ``c``, where the float64 sum lands on the
    midpoint and a second rounding would go the wrong way, and on random
    triples."""
    from fractions import Fraction
    rng = np.random.RandomState(5)
    n = 600
    k, j = 2 * rng.randint(0, 32, (2, n)) + 1
    a, b = (1 + k * 2. ** -12).astype(np.float32), (1 + j * 2. ** -12).astype(np.float32)
    c = (rng.choice([-1., 0., 1.], n) * 2. ** -60 * rng.randint(1, 8, n)).astype(np.float32)
    a = np.concatenate([a, rng.randn(n).astype(np.float32)])
    b = np.concatenate([b, rng.randn(n).astype(np.float32)])
    c = np.concatenate([c, rng.randn(n).astype(np.float32)])
    got = _draw._fma(a, b, c)
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (twice != got).sum() > 100                # the cases do round twice
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        near = np.float32(float(exact))
        cands = [np.nextafter(near, np.float32(-np.inf)), near,
                 np.nextafter(near, np.float32(np.inf))]
        err = [abs(Fraction(float(v)) - exact) for v in cands]
        best = [v for v, e in zip(cands, err) if e == min(err)]
        want = best[0] if len(best) == 1 else [v for v in best if not v.view(np.int32) & 1][0]
        assert g.view(np.int32) == want.view(np.int32), (x, y, z)
