"""Host-side image and contour helpers (numpy).

Counterpart of ``celldetection_tpu/data/misc.py``: ``normalize_percentile``
(79-100), ``random_crop`` (103-111), ``random_pad`` (114-124),
``resample_contours`` (143-179), ``labels2properties`` (195-225),
``rgb_to_scalar`` (137-140), ``regionprops2d`` (228-238) and
``labels2property_table`` (254-299), ``channels_first2channels_last`` (22),
``channels_last2channels_first`` (30), ``transpose_spatial`` (34),
``padding_stack`` (41), ``universal_dict_collate_fn`` (56), ``rle2mask``
(126), ``pad_to_size`` (182), ``pad_to_div`` (188), ``split`` (241) and
``labels2crops`` (302), copied so that the port imports nothing of the JAX
package. The JAX package's
property table is a ``pandas.DataFrame``; the port's is a
:class:`PropertyTable` of the same columns and rows, written as pandas'
``to_csv(index=False)`` writes that frame, without pandas.
"""
import csv
import numbers
from collections import OrderedDict
from typing import List, Union

import numpy as np

__all__ = ['normalize_percentile', 'random_crop', 'random_pad', 'resample_contours',
           'rgb_to_scalar',
           'labels2properties', 'regionprops2d', 'labels2property_table', 'PropertyTable',
           'channels_first2channels_last', 'channels_last2channels_first', 'transpose_spatial',
           'padding_stack', 'universal_dict_collate_fn', 'rle2mask', 'pad_to_size', 'pad_to_div',
           'split', 'labels2crops']


def normalize_percentile(image: np.ndarray, percentile=99.9, to_uint8: bool = False,
                         lower: float = None) -> np.ndarray:
    """Two-sided percentile normalisation to [0, 1] (optionally uint8).

    Maps the (100 - p)th..pth percentile window to [0, 1] with clipping, so a
    camera baseline is removed, not just divided through. ``percentile`` may
    be a (low, high) tuple; ``lower`` overrides the low percentile.
    """
    if isinstance(percentile, (list, tuple)):
        p_low, p_high = percentile
    else:
        p_low, p_high = 100. - percentile, percentile
    if lower is not None:
        p_low = lower
    low, high = np.percentile(image, (p_low, p_high))
    denom = max(high - low, 1e-12)
    img = (image.astype('float32') - low) / denom
    img = np.clip(img, 0., 1.)
    if to_uint8:
        img = (img * 255).astype('uint8')
    return img


def random_crop(*arrays, height: int, width: int = None, rng: np.random.RandomState = None):
    """Random crop applied consistently to all inputs (leading spatial dims)."""
    rng = rng or np.random
    width = width or height
    h, w = arrays[0].shape[:2]
    y = rng.randint(0, max(h - height, 0) + 1)
    x = rng.randint(0, max(w - width, 0) + 1)
    out = tuple(a[y:y + height, x:x + width] for a in arrays)
    return out if len(out) > 1 else out[0]


def random_pad(*arrays, height: int, width: int = None, rng: np.random.RandomState = None,
               **kwargs):
    """Random split of the padding that brings every input to at least (height, width)."""
    rng = rng or np.random
    width = width or height
    h, w = arrays[0].shape[:2]
    ph, pw = max(0, height - h), max(0, width - w)
    ty, tx = (rng.randint(0, p + 1) if p else 0 for p in (ph, pw))
    out = tuple(np.pad(a, [(ty, ph - ty), (tx, pw - tx)] + [(0, 0)] * (a.ndim - 2), **kwargs)
                for a in arrays)
    return out if len(out) > 1 else out[0]


def rgb_to_scalar(image: np.ndarray, dtype='int32') -> np.ndarray:
    """Pack an RGB label encoding ``[..., 3]`` into scalar labels ``r + g << 8 + b << 16``."""
    image = image.astype(dtype)
    return image[..., 0] + (image[..., 1] << 8) + (image[..., 2] << 16)


def resample_contours(contours, num: Union[int, float, None] = None, close: bool = True,
                      epsilon: float = 1e-6):
    """Sample ``num`` points at equal arc length along each contour ``[..., p, 2]``.

    A list or tuple of such arrays is resampled item by item. The targets are
    located on every row's arc-length profile by one flat ``searchsorted``
    (each row shifted into a range of its own).
    """
    if isinstance(contours, (list, tuple)):
        return type(contours)(resample_contours(c, num=num, close=close, epsilon=epsilon)
                              for c in contours)
    pts = np.asarray(contours, dtype=float)
    if close:
        pts = np.concatenate((pts, pts[..., :1, :]), -2)
    seg_len = np.linalg.norm(np.diff(pts, axis=-2), axis=-1) + epsilon
    arc = np.concatenate([np.zeros(seg_len.shape[:-1] + (1,), seg_len.dtype),
                          np.cumsum(seg_len, axis=-1)], axis=-1)
    total = arc[..., -1]
    if num is None or isinstance(num, float):
        num = int(np.max(np.round(total)) * (num if isinstance(num, float) else 1))
    t = total[..., None] * (np.arange(num, dtype=float) / num)

    p = pts.shape[-2]
    flat_arc = arc.reshape(-1, p)
    flat_t = t.reshape(-1, num)
    flat_pts = pts.reshape(-1, p, 2)
    rows = flat_arc.shape[0]
    stride = float(flat_arc[:, -1].max()) + 1.0
    shift = np.arange(rows, dtype=float)[:, None] * stride
    ins = np.searchsorted((flat_arc + shift).ravel(), (flat_t + shift).ravel())
    k = np.maximum(ins.reshape(rows, num) - np.arange(rows)[:, None] * p, 1) - 1
    r = np.arange(rows)[:, None]
    alpha = ((flat_t - flat_arc[r, k]) / (flat_arc[r, k + 1] - flat_arc[r, k]))[..., None]
    out = flat_pts[r, k] * (1 - alpha) + flat_pts[r, k + 1] * alpha
    return out.reshape(pts.shape[:-2] + (num, 2))


def labels2properties(labels: np.ndarray, *properties, offset=(0, 0), spacing=None):
    """Per-region rows of the named properties (label, bbox, image, coords,
    area, centroid) of a label image ``[H, W]`` or ``[H, W, C]``; ``offset``
    (pixels) shifts bbox, coords and centroid; ``spacing`` scales area and
    centroid to physical units. One property gives its values, not rows."""
    from ._regionprops import regionprops
    if len(properties) == 1 and isinstance(properties[0], (list, tuple)):
        properties, = properties
    if labels.ndim == 2:
        labels = labels[..., None]
    rows = []
    for z in range(labels.shape[2]):
        for p in regionprops(labels[..., z], spacing=spacing):
            row = []
            for name in properties:
                v = getattr(p, name)
                if name == 'bbox' and any(offset):
                    v = (v[0] + offset[0], v[1] + offset[1], v[2] + offset[0], v[3] + offset[1])
                elif name == 'coords' and any(offset):
                    v = v + np.asarray(offset)
                elif name == 'centroid' and any(offset):
                    # the offset is in pixels: scaled by the spacing like the centroid
                    off = np.asarray(offset, float)
                    if spacing is not None:
                        off = off * np.broadcast_to(
                            np.atleast_1d(np.asarray(spacing, float)), off.shape)
                    v = tuple(np.asarray(v) + off)
                row.append(v)
            rows.append(row if len(properties) > 1 else row[0])
    return rows


def regionprops2d(label_image: np.ndarray, **kwargs):
    """Region properties of each channel of a label image ``[H, W]`` or
    ``[H, W, C]``, channel after channel."""
    from ._regionprops import regionprops
    assert label_image.ndim in (2, 3)
    if label_image.ndim == 2:
        label_image = label_image[..., None]
    for z in range(label_image.shape[2]):
        yield from regionprops(label_image[..., z], **kwargs)


def _is_int(v) -> bool:
    return isinstance(v, numbers.Integral) and not isinstance(v, (bool, np.bool_))


class PropertyTable:
    """Region properties as rows under named columns: the columns and rows of
    the JAX package's ``pd.DataFrame``, without pandas.

    ``rows`` are dicts; a row that lacks a column holds nothing there.
    :meth:`to_csv` writes what pandas' ``DataFrame.to_csv(index=False)``
    writes: a column of integers alone as integers, any other number column
    as floats (``repr``, so ``3.0``), a missing value as an empty field.
    """

    def __init__(self, columns, rows):
        self.columns = list(columns)
        self.rows = list(rows)

    def __len__(self) -> int:
        return len(self.rows)

    def column(self, name) -> list:
        """The column's values, ``None`` where a row lacks it."""
        return [r.get(name) for r in self.rows]

    def _format(self, name):
        values = [v for v in self.column(name) if v is not None]
        complete = len(values) == len(self.rows)
        if complete and all(_is_int(v) for v in values):
            return lambda v: str(int(v))
        if all(isinstance(v, numbers.Real) for v in values):
            return lambda v: '' if v is None else repr(float(v))
        return lambda v: '' if v is None else str(v)

    def to_csv(self, path):
        """Write the table as CSV (a header line, then one line per row, no
        index column)."""
        formats = [self._format(c) for c in self.columns]
        with open(path, 'w', newline='') as f:
            writer = csv.writer(f, lineterminator='\n')
            writer.writerow(self.columns)
            for row in self.rows:
                writer.writerow([fmt(row.get(c)) for fmt, c in zip(formats, self.columns)])


def labels2property_table(labels: np.ndarray, *properties, iter_channels: bool = True,
                          spacing=None, separator: str = '-', **kwargs) -> PropertyTable:
    """Per-region property table.

    The channels of a multi-channel label image are iterated and their
    regions concatenated unless ``iter_channels`` is False (then the stack
    is one n-d label image). Vector properties expand into
    ``separator``-joined columns (``bbox-0`` ... as ``regionprops_table``),
    also where the table is empty; ``spacing`` scales area and centroid to
    physical units.
    """
    from ._regionprops import regionprops
    if len(properties) == 1 and isinstance(properties[0], (list, tuple)):
        properties, = properties
    if iter_channels and labels.ndim > 2:
        props = []
        for z in range(labels.shape[2]):
            props += regionprops(labels[..., z], spacing=spacing)
    else:
        props = regionprops(labels, spacing=spacing)
    nd = labels.ndim if not (iter_channels and labels.ndim > 2) else 2
    widths = {'bbox': 2 * nd, 'centroid': nd}
    columns = []
    for name in properties:
        if name in widths:
            columns += [f'{name}{separator}{i}' for i in range(widths[name])]
        else:
            columns.append(name)
    data = []
    for p in props:
        row = {}
        for name in properties:
            v = getattr(p, name)
            if np.ndim(v) == 0 or name == 'coords':
                row[name] = v
            else:
                for i, vi in enumerate(np.asarray(v).reshape(-1)):
                    row[f'{name}{separator}{i}'] = vi
        data.append(row)
        for k in row:
            if k not in columns:
                columns.append(k)
    return PropertyTable(columns, data)


def channels_first2channels_last(x: np.ndarray, spatial_dims: int = 2, has_batch: bool = False) -> np.ndarray:
    c = x.ndim - spatial_dims - int(has_batch)
    perm = tuple(range(int(has_batch))) + tuple(range(x.ndim - spatial_dims, x.ndim)) + \
        tuple(range(int(has_batch), int(has_batch) + c))
    # simpler: move the channel axes to the end
    return np.moveaxis(x, int(has_batch), -1) if c == 1 else np.transpose(x, perm)


def channels_last2channels_first(x: np.ndarray, spatial_dims: int = 2, has_batch: bool = False) -> np.ndarray:
    return np.moveaxis(x, -1, int(has_batch))


def transpose_spatial(x: np.ndarray, inputs_channels_last: bool = True, spatial_dims: int = 2):
    """Bring an array to channels-last (the framework's native layout)."""
    if inputs_channels_last:
        return x
    return channels_first2channels_last(x, spatial_dims)


def padding_stack(*images, axis: int = 0) -> np.ndarray:
    """Stack arrays along a new axis, end-padding all dims to the largest extent."""
    if len(images) == 1 and isinstance(images[0], (list, tuple)):
        images = tuple(images[0])
    nd = max(i.ndim for i in images)
    shapes = [(1,) * (nd - i.ndim) + i.shape for i in images]
    target = tuple(max(s[d] for s in shapes) for d in range(nd))
    out = []
    for i in images:
        i = i.reshape((1,) * (nd - i.ndim) + i.shape)
        pad = [(0, t - s) for t, s in zip(target, i.shape)]
        out.append(np.pad(i, pad))
    return np.stack(out, axis)


def universal_dict_collate_fn(batch: List[dict], check_padding: bool = True) -> OrderedDict:
    """Collate a list of dicts into a dict of padding-stacked arrays.

    ``None`` items (e.g. skipped tiles) are dropped. Values that are lists of
    per-object arrays are padding-stacked with a companion ``<key>_size`` entry
    left to the caller. Parity: ``celldetection/data/misc.py:136-153``.
    """
    batch = [b for b in batch if b is not None]
    if len(batch) == 0:
        return OrderedDict()
    keys = batch[0].keys()
    out = OrderedDict()
    for k in keys:
        vals = [b[k] for b in batch]
        if vals[0] is None:
            out[k] = None
        elif isinstance(vals[0], np.ndarray):
            out[k] = padding_stack(*vals, axis=0)
        else:
            out[k] = vals
    return out


def rle2mask(code, size, transpose: bool = True, min_index: int = 1, constant: int = 1) -> np.ndarray:
    """Run-length code → binary mask. Parity: ``celldetection/data/misc.py:231``."""
    image = np.zeros(int(np.prod(size)), dtype=np.uint8)
    code = np.asarray(code).ravel()
    starts, lengths = code[::2] - min_index, code[1::2]
    for s, l in zip(starts, lengths):
        image[s:s + l] = constant
    image = image.reshape(size[::-1] if transpose else size)
    return image.T if transpose else image


def pad_to_size(v: np.ndarray, size, **kwargs) -> np.ndarray:
    pad = [[0, max(0, a - b)] for a, b in zip(size, v.shape)]
    pad += [[0, 0]] * (v.ndim - len(pad))
    return np.pad(v, pad, **kwargs)


def pad_to_div(v: np.ndarray, div: int = 32, nd: int = 2, **kwargs) -> np.ndarray:
    if not isinstance(div, (tuple, list)):
        div = (div,) * nd
    size = [(i // d + bool(i % d)) * d for i, d in zip(v.shape, div)]
    return pad_to_size(v, size, **kwargs)


def split(n: int, *fractions, shuffle: bool = True, seed=None):
    """Partition ``range(n)`` into index sets by fractions summing to 1
    (parity: ``split``, ``celldetection/data/misc.py:489``)."""
    if abs(sum(fractions) - 1.) > 1e-9:
        raise ValueError('The sum of splits must be equal to 1.')
    rng = np.random.RandomState(seed)
    idx = np.arange(n)
    if shuffle:
        rng.shuffle(idx)
    bounds = np.cumsum([int(round(f * n)) for f in fractions])[:-1]
    return [np.sort(part) for part in np.split(idx, bounds)]


def labels2crops(labels: np.ndarray, image: np.ndarray):
    """Crop every labeled object from ``image``; returns (crops, masks)."""
    crops, masks = [], []
    for (y0, x0, y1, x1), mask in labels2properties(labels, 'bbox', 'image'):
        crops.append(image[y0:y1, x0:x1])
        masks.append(mask)
    return crops, masks
