"""Synthetic toy data: random blob instances with labels, without cv2.

Counterpart of ``celldetection_tpu/data/toydata.py``: the shape painters
``random_circle``, ``random_ellipse``, ``random_rectangle`` and
``random_triangle`` (34-66), ``random_geometric_objects`` (68-107),
``random_geometric_shapes`` (110-153) and ``synthetic_cells`` (156-158).
Each draws the same numbers from the same ``np.random.RandomState`` in the
same order, and draws with :mod:`._draw`, which gives what cv2 gives pixel
for pixel (the blur bit for bit), so a seed gives the JAX package's image
and labels.
"""
import numpy as np

from . import _draw

__all__ = ['random_geometric_objects', 'random_geometric_shapes', 'synthetic_cells',
           'random_circle', 'random_ellipse', 'random_rectangle', 'random_triangle',
           'CLASS_NAMES_GEOMETRIC']

# class ids of the multiclass toy scene
CLASS_NAMES_GEOMETRIC = {
    1: 'rectangle',
    2: 'triangle',
    3: 'ellipse',
}


def _paint(image, mask, color):
    """Apply the filled mask to the image with the given color/intensity."""
    sel = mask > 0
    if image.ndim == 3:
        image[sel] = color
    else:
        image[sel] = np.maximum(image[sel], float(np.mean(color)) if np.ndim(color) else color)
    return image, mask


def random_circle(image, mask, x, y, color, radius_range=(3, 28), rng=None):
    """Draw a random filled circle at (x, y) into ``mask`` and ``image``; returns (image, mask)."""
    rng = rng or np.random
    r = int(rng.randint(*radius_range))
    _draw.circle(mask, (int(x), int(y)), r, 1)
    return _paint(image, mask, color)


def random_ellipse(image, mask, x, y, color, radius_range=(3, 28), rng=None):
    """Draw a random filled ellipse (random axes and angle) at (x, y)."""
    rng = rng or np.random
    axes = (int(rng.randint(*radius_range)), int(rng.randint(*radius_range)))
    angle = float(rng.randint(0, 180))
    _draw.ellipse(mask, (int(x), int(y)), axes, angle, 1)
    return _paint(image, mask, color)


def random_rectangle(image, mask, x, y, color, radius_range=(3, 28), rng=None):
    """Draw a random filled axis-aligned rectangle centred at (x, y)."""
    rng = rng or np.random
    w, h = rng.randint(*radius_range), rng.randint(*radius_range)
    _draw.rectangle(mask, (int(x - w), int(y - h)), (int(x + w), int(y + h)), 1)
    return _paint(image, mask, color)


def random_triangle(image, mask, x, y, color, radius_range=(3, 28), rng=None):
    """Draw a random filled triangle on a circle of random radius around (x, y)."""
    rng = rng or np.random
    r = rng.randint(*radius_range)
    angles = np.sort(rng.rand(3) * 2 * np.pi)
    pts = np.stack([x + r * np.cos(angles), y + r * np.sin(angles)], -1)
    _draw.fill_poly(mask, np.round(pts).astype(np.int32), 1)
    return _paint(image, mask, color)


def random_geometric_objects(height: int = 256, width: int = 256, num: int = 24,
                             radius: tuple = (8, 24), seed=None, channels: int = 1):
    """Random deformed-ellipse instances.

    Returns:
        ``(image, labels)``: image ``float32[h, w]`` in [0, 1] (blurred, with
        noise), labels ``int32[h, w, channels]`` (channels resolve overlaps).
    """
    rng = np.random.RandomState(seed)
    labels = np.zeros((height, width, channels), dtype=np.int32)
    image = np.zeros((height, width), dtype=np.float32)
    lbl = 0
    for _ in range(num):
        r = rng.randint(radius[0], radius[1])
        cx = rng.randint(r + 1, width - r - 1)
        cy = rng.randint(r + 1, height - r - 1)
        theta = np.linspace(0, 2 * np.pi, 72, endpoint=False)
        rr = r * (1 + 0.25 * np.sin(theta * rng.randint(2, 5) + rng.rand() * 6.28) * rng.rand())
        ax = 0.6 + 0.4 * rng.rand()
        pts = np.stack([cx + rr * np.cos(theta) * ax, cy + rr * np.sin(theta)], -1)
        mask = np.zeros((height, width), dtype=np.uint8)
        _draw.fill_poly(mask, np.round(pts).astype(np.int32), 1)
        if mask.sum() < 9:
            continue
        # place into the first channel without existing labels in the region
        placed = False
        for c in range(channels):
            if not (labels[..., c][mask > 0] > 0).any():
                lbl += 1
                labels[..., c][mask > 0] = lbl
                placed = True
                break
        if not placed:
            continue
        intensity = 0.4 + 0.5 * rng.rand()
        image[mask > 0] = np.maximum(image[mask > 0], intensity)
    image = _draw.gaussian_blur(image, (5, 5), 1.5)
    image = image + rng.randn(height, width).astype(np.float32) * 0.03
    return np.clip(image, 0, 1), labels


def random_geometric_shapes(height: int = 256, width: int = 256,
                            radius_range: tuple = (3, 28),
                            intensity_range: tuple = (0, 180), margin: int = 13,
                            seed=None):
    """Multiclass toy scene: coloured rectangles, triangles and ellipses on a
    jittered grid (class ids as :data:`CLASS_NAMES_GEOMETRIC`).

    Returns:
        ``(image, masks, labels, classes)``: image ``uint8[h, w, 3]`` (white
        background), masks ``uint8[n, h, w]``, labels ``int[h, w, n]`` (one
        channel per instance, values ``idx+1``), classes ``int[n]``.
    """
    rng = np.random.RandomState(seed)
    image = np.full((height, width, 3), 255, dtype=np.uint8)
    mrad = int(np.max(radius_range))
    step = int(mrad * 1.5)
    xs = np.arange(margin + mrad, width - mrad - margin, step)
    ys = np.arange(margin + mrad, height - mrad - margin, step)
    masks, labels, classes = [], [], []
    for x0 in xs:
        for y0 in ys:
            rad = int(rng.randint(*radius_range))
            x = int(x0) + int(rng.randint(0, max(int(rad * .5), 1)))
            y = int(y0) + int(rng.randint(0, max(int(rad * .5), 1)))
            color = rng.randint(*intensity_range, 3).tolist()
            variant = int(rng.choice([1, 2, 3]))
            mask = np.zeros((height, width), dtype=np.uint8)
            draw = {1: random_rectangle, 2: random_triangle, 3: random_ellipse}[variant]
            image, mask = draw(image, mask, x, y, color, radius_range=radius_range, rng=rng)
            if mask.sum() == 0:
                continue
            classes.append(variant)
            masks.append(mask)
            labels.append(mask.astype(np.int32) * (len(masks)))
    if not masks:  # degenerate geometry (tiny canvas): keep the shapes consistent
        return (image, np.zeros((0, height, width), np.uint8),
                np.zeros((height, width, 0), np.int32), np.zeros(0, np.int64))
    return image, np.asarray(masks), np.stack(labels, -1), np.asarray(classes)


def synthetic_cells(n: int = 8, height: int = 256, width: int = 256, seed: int = 0, **kwargs):
    """Batch of synthetic examples: list of (image, labels) tuples."""
    return [random_geometric_objects(height, width, seed=seed + i, **kwargs) for i in range(n)]
