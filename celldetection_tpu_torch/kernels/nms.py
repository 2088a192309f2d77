"""Exact greedy NMS sweep: the hand-written Hopper kernel ``csrc/nms_sweep.cu``.

Replaces ``celldetection_tpu/kernels/nms_pallas.py:_nms_kernel`` (the only
Pallas kernel of the JAX package; ``pallas_call`` at line 149). As in the
JAX package, the wrapper around the kernel (``ops/boxes.py:nms_padded``)
sorts by score, gathers the boxes and scatters the keep mask back to the
original order; the kernel does the sweep over the sorted boxes, one CTA per
image, every image of the batch in one launch. The source explains what
bounds it on this card and what its design does about it.

The plain version is ``ops/boxes.py:_nms_sweep``: :func:`nms_sweep` runs it
for a CPU tensor and launches the kernel for a CUDA tensor; there is no
fallback from one to the other.
"""
import ctypes
import functools

import torch

from ..ops.boxes import _nms_sweep
from .build import KernelLibrary, build_library

__all__ = ['nms_sweep', 'nms_library']

SOURCE = 'nms_sweep.cu'


@functools.cache
def nms_library() -> KernelLibrary:
    """Build (at first use) and load the kernel's library."""
    built = build_library(SOURCE)
    fn = built.lib.cdt_nms_sweep
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    built.lib.cdt_cuda_error_string.argtypes = [ctypes.c_int]
    built.lib.cdt_cuda_error_string.restype = ctypes.c_char_p
    return built


def nms_sweep(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy NMS keep mask over score-sorted boxes.

    Args:
        boxes: ``[B, M, 4]`` float32, each image sorted by descending score.
        valid: ``[B, M]`` bool.
        iou_threshold: Suppression threshold (strictly greater).

    Returns:
        ``[B, M]`` bool keep mask in the given (sorted) order.
    """
    if boxes.device.type == 'cpu':
        return _nms_sweep(boxes, valid, iou_threshold)
    if boxes.device.type != 'cuda':
        raise ValueError(f'nms_sweep: no kernel for device {boxes.device}')
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f'nms_sweep takes float32 boxes and bool valid, got '
                        f'{boxes.dtype} and {valid.dtype}')
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or valid.shape != boxes.shape[:2]:
        raise ValueError(f'nms_sweep: boxes {tuple(boxes.shape)} and valid '
                         f'{tuple(valid.shape)} are not [B, M, 4] and [B, M]')
    if valid.device != boxes.device:
        raise ValueError('nms_sweep: boxes and valid lie on different devices')
    if not (boxes.is_contiguous() and valid.is_contiguous()) or boxes.data_ptr() % 16:
        raise ValueError('nms_sweep: inputs must be contiguous, boxes 16-byte aligned')
    bsz, m = valid.shape
    if bsz * m >= 2 ** 31:
        raise ValueError(f'nms_sweep: {bsz} x {m} boxes exceed the kernel\'s int indexing')
    keep = torch.empty_like(valid)
    if keep.numel() == 0:
        return keep
    lib = nms_library().lib
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = lib.cdt_nms_sweep(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                                bsz, m, float(iou_threshold), stream)
    if err:
        raise RuntimeError(f'nms_sweep launch failed: '
                           f'{lib.cdt_cuda_error_string(err).decode()}')
    nms_sweep.launches += 1
    return keep


nms_sweep.launches = 0  # kernel launches since the last reset (set to 0 to reset)
