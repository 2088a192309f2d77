"""Tiling math for sliding-window inference (numpy).

Counterpart of ``celldetection_tpu/util/tiling.py`` (lines 16-101):
``calculate_padding``, ``ensure_num_tuple``, ``Tiling`` and
``get_tiling_slices``, copied so that the port imports nothing of the JAX
package. Last tiles align to the image edge (stop-anchored), and each tile
reports its (start, end) overlaps per axis, which the border and stitching
filters of :mod:`..parallel.tiles` consume.
"""
from itertools import product
from typing import Sequence, Union

import numpy as np

__all__ = ['Tiling', 'get_tiling_slices', 'ensure_num_tuple', 'calculate_padding']


def calculate_padding(input_size: int, kernel_size: int, stride: int, dilation: int,
                      padding_mode: str = 'same') -> int:
    """Conv padding for the 'same' and 'valid' modes."""
    if padding_mode == 'same':
        return ((input_size - 1) * (stride - 1) + dilation * (kernel_size - 1)) // 2
    if padding_mode == 'valid':
        return 0
    raise ValueError(f'Unsupported padding mode: {padding_mode!r}')


def ensure_num_tuple(v, n: int):
    if isinstance(v, (int, float, np.integer, np.floating)):
        return (v,) * n
    assert len(v) == n
    return tuple(v)


class Tiling:
    """Grid tiling of a context into ``tile_size`` tiles with optional overlap."""

    def __init__(self, tile_size: tuple, context_shape: tuple, overlap: int = 0):
        self.overlap = overlap
        self.tile_size = tuple(tile_size)
        self.context_size = tuple(context_shape[:len(self.tile_size)])
        self.num_tiles_per_dim = np.ceil(np.array(self.context_size) /
                                         np.array(self.tile_size)).astype('int')
        self.num_tiles = int(np.prod(self.num_tiles_per_dim))

    def __len__(self):
        return self.num_tiles

    def __getitem__(self, item):
        if item >= len(self):
            raise IndexError
        tile_index = np.unravel_index(item, shape=tuple(self.num_tiles_per_dim))
        start = np.asarray(tile_index) * np.array(self.tile_size)
        stop = np.minimum(start + self.tile_size, self.context_size)
        start_wo = np.maximum(start - self.overlap, 0)
        stop_wo = np.minimum(stop + self.overlap, self.context_size)
        start_ex = start - start_wo
        stop_ex = start - start_wo + stop - start
        return dict(
            start=start, stop=stop,
            slices=tuple(slice(a, b) for a, b in zip(start, stop)),
            slices_with_overlap=tuple(slice(a, b) for a, b in zip(start_wo, stop_wo)),
            slices_to_remove_overlap=tuple(slice(a, b) for a, b in zip(start_ex, stop_ex)),
            start_ex=start_ex, stop_ex=stop_ex,
            start_with_overlap=start_wo, stop_with_overlap=stop_wo,
            num_tiles=self.num_tiles, num_tiles_per_dim=self.num_tiles_per_dim,
        )


def get_tiling_slices(size: Sequence[int], crop_size: Union[int, Sequence[int]],
                      strides: Union[int, Sequence[int]], return_overlaps: bool = False):
    """Sliding-window slices over ``size`` with edge-aligned last tiles.

    Returns ``(slices_iter, shape)`` or ``(slices_iter, overlaps_iter, shape)``
    where each overlap entry is ``((oy0, oy1), (ox0, ox1))``: the pixel
    overlap with the previous and the next tile per axis.
    """
    assert isinstance(size, (tuple, list))
    crop_size = ensure_num_tuple(crop_size, len(size))
    strides = ensure_num_tuple(strides, len(size))
    slices, shape, overlaps = [], [], []
    for axis in range(len(size)):
        if crop_size[axis] >= size[axis]:
            tl = [size[axis]]
        else:
            n_steps = int(np.ceil((size[axis] - crop_size[axis]) / strides[axis]))
            tl = range(crop_size[axis], 1 + crop_size[axis] + n_steps * strides[axis],
                       strides[axis])
        stops = np.minimum(tl, size[axis])
        starts = np.maximum(0, stops - crop_size[axis])
        # clamp: strides > crop_size yield gaps, not negative overlaps
        overlaps_start = np.maximum(np.concatenate((starts[:1], stops[:-1])) - starts, 0)
        overlaps_end = np.concatenate((overlaps_start[1:], [0]))
        axis_slices = [slice(int(a), int(b)) for a, b in zip(starts, stops)]
        axis_overlaps = [(int(a), int(b)) for a, b in zip(overlaps_start, overlaps_end)]
        slices.append(axis_slices)
        shape.append(len(starts))
        overlaps.append(axis_overlaps)
    slices_iter = product(*slices)
    if return_overlaps:
        return slices_iter, product(*overlaps), tuple(shape)
    return slices_iter, tuple(shape)
