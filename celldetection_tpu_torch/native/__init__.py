"""Host C++ of the port, built with ``g++`` at first use and loaded with ctypes.

The port's copy of ``celldetection_tpu/native`` (``rasterize.cpp`` and its
adapter): a scanline fill of contours into a flat label image, the
``fast_labels`` path of :meth:`..runtime.trainer.CPNTrainer.validate`. The
library is compiled at the first call, never at import, into
``celldetection_tpu_torch/_build/`` under a name that carries a hash of the
source, so an edited source rebuilds.
"""
import ctypes
import functools
import hashlib
import os
import subprocess

import numpy as np

from ..kernels.build import BUILD_DIR

__all__ = ['rasterize_library', 'rasterize_labels_native', 'contours2labels_native']

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'rasterize.cpp')
GXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17', '-pthread')


@functools.lru_cache(maxsize=None)
def rasterize_library() -> ctypes.CDLL:
    """Build (if not built yet) and load ``rasterize.cpp``; raises when the
    build fails."""
    with open(SOURCE, 'rb') as f:
        digest = hashlib.sha1(f.read() + ' '.join(GXX_FLAGS).encode()).hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f'librasterize_{digest}.so')
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f'{out}.{os.getpid()}.tmp'
        proc = subprocess.run(['g++', *GXX_FLAGS, SOURCE, '-o', tmp], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'g++ failed on {SOURCE}:\n{proc.stdout}\n{proc.stderr}')
        os.replace(tmp, out)   # atomic: a concurrent build never loads a partial file
    lib = ctypes.CDLL(out)
    lib.rasterize_labels.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)]
    lib.rasterize_labels_mt.argtypes = lib.rasterize_labels.argtypes + [ctypes.c_int32]
    return lib


def rasterize_labels_native(contours, size, num_threads: int = 0) -> np.ndarray:
    """Fill contours into an int32 label image (label = index + 1).

    Args:
        contours: Sequence of (num_points, 2) xy arrays (ragged ok).
        size: (height, width).
        num_threads: 0 = auto (cpu count, any-wins overlap), 1 = sequential
            deterministic last-wins.

    Returns:
        ``Array[height, width]`` int32. Raises when the library cannot be built.
    """
    lib = rasterize_library()
    # reshape first, count from the reshaped rows: for flat (2n,) inputs
    # len(c) != point count and the C++ fill would read past the buffer
    arrs = [np.asarray(c, np.float64).reshape(-1, 2) for c in contours]
    counts = np.asarray([len(a) for a in arrs], np.int64)
    offsets = np.zeros(len(arrs), np.int64)
    if len(arrs) > 1:
        offsets[1:] = np.cumsum(counts)[:-1]
    flat = np.ascontiguousarray(np.concatenate(arrs) if arrs else np.zeros((0, 2)), np.float64)
    out = np.zeros(tuple(size), np.int32)
    if num_threads == 0:
        num_threads = min(os.cpu_count() or 1, 16)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    lib.rasterize_labels_mt(p(flat, ctypes.c_double), p(offsets, ctypes.c_int64),
                            p(counts, ctypes.c_int64), len(arrs), size[0], size[1],
                            p(out, ctypes.c_int32), num_threads)
    return out


def contours2labels_native(contours, size, fallback: bool = True) -> np.ndarray:
    """Flat label image from contours by the native scanline fill (overlaps
    resolved by paint order, the last wins).

    ``fallback``: without a working ``g++`` build, resolve the channelled
    render instead (:func:`..data.cpn.contours2labels`,
    :func:`..data.cpn.resolve_label_channels`), as the JAX package does;
    with False a failed build raises.
    """
    try:
        return rasterize_labels_native(contours, size, num_threads=1)
    except (OSError, RuntimeError):
        if not fallback:
            raise
    from ..data.cpn import contours2labels, resolve_label_channels
    return resolve_label_channels(contours2labels(list(contours), tuple(size)))
