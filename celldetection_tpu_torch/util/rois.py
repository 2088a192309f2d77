"""ImageJ ROI export for contours.

The port's own copy of ``celldetection_tpu/util/rois.py`` (numpy): the
ImageJ ``.roi`` polygon binary format and ``.zip`` collections, readable by
ImageJ/Fiji's ROI manager.
"""
import struct
import zipfile
from typing import Sequence

import numpy as np

__all__ = ['contour2roi_bytes', 'roi_bytes2contour', 'save_rois', 'load_imagej_rois']

_HEADER_SIZE = 64
_POLYGON = 0


def contour2roi_bytes(contour: np.ndarray, name: str = 'roi') -> bytes:
    """One (num_points, 2) xy contour → ImageJ .roi polygon bytes."""
    contour = np.asarray(contour)
    xs = np.round(contour[:, 0]).astype(np.int16)
    ys = np.round(contour[:, 1]).astype(np.int16)
    left, top = int(xs.min()), int(ys.min())
    right, bottom = int(xs.max()), int(ys.max())
    n = len(contour)
    header = bytearray(_HEADER_SIZE)
    header[0:4] = b'Iout'                       # magic
    struct.pack_into('>h', header, 4, 227)      # version
    header[6] = _POLYGON                        # roi type
    struct.pack_into('>hhhh', header, 8, top, left, bottom, right)
    struct.pack_into('>H', header, 16, n)
    body = b''.join(struct.pack('>h', int(x - left)) for x in xs) + \
           b''.join(struct.pack('>h', int(y - top)) for y in ys)
    return bytes(header) + body


def save_rois(filename: str, contours: Sequence[np.ndarray]):
    """Write contours as an ImageJ ROI set (``.zip``) or single ``.roi``."""
    if filename.endswith('.roi'):
        assert len(contours) == 1
        with open(filename, 'wb') as f:
            f.write(contour2roi_bytes(contours[0]))
        return filename
    with zipfile.ZipFile(filename, 'w', zipfile.ZIP_DEFLATED) as z:
        for i, con in enumerate(contours):
            z.writestr(f'{i + 1:04d}.roi', contour2roi_bytes(con))
    return filename


def roi_bytes2contour(data: bytes) -> np.ndarray:
    """ImageJ polygon ``.roi`` bytes → (num_points, 2) xy contour (inverse of
    :func:`contour2roi_bytes`; parity: ``load_imagej_rois``,
    ``celldetection/util/util.py``)."""
    if data[:4] != b'Iout':
        raise ValueError('Not an ImageJ ROI (missing Iout magic)')
    top, left = struct.unpack_from('>hh', data, 8)
    n, = struct.unpack_from('>H', data, 16)
    xs = np.frombuffer(data, '>i2', n, _HEADER_SIZE).astype(np.int64) + left
    ys = np.frombuffer(data, '>i2', n, _HEADER_SIZE + 2 * n).astype(np.int64) + top
    return np.stack([xs, ys], -1).astype(float)


def load_imagej_rois(filename: str):
    """Load an ImageJ ROI ``.zip`` set or a single ``.roi``.

    Returns:
        ``(boxes, contours)`` — ``Array[n, 4]`` xyxy boxes and a list of
        ``(points, 2)`` contours (parity: ``load_imagej_rois``,
        ``celldetection/util/util.py:1949-1980``).
    """
    if filename.endswith('.roi'):
        with open(filename, 'rb') as f:
            contours = [roi_bytes2contour(f.read())]
    else:
        with zipfile.ZipFile(filename) as z:
            contours = [roi_bytes2contour(z.read(name)) for name in sorted(z.namelist())
                        if name.endswith('.roi')]
    boxes = np.array([[c[:, 0].min(), c[:, 1].min(), c[:, 0].max(), c[:, 1].max()]
                      for c in contours], float).reshape(-1, 4)
    return boxes, contours
