"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

``KERNELS`` lists the launch wrappers; each carries a ``launches`` counter.
``nms_sweep`` is the entry point that drives the NMS kernels.
"""
from .nms import nms_bits_count, nms_bits_fill, nms_resolve, nms_sweep

KERNELS = (nms_bits_count, nms_bits_fill, nms_resolve)

__all__ = ['nms_sweep', 'nms_bits_count', 'nms_bits_fill', 'nms_resolve', 'KERNELS']
