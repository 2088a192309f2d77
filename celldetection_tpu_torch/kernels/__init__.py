"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

``KERNELS`` lists the NMS kernels' launch wrappers; each carries a
``launches`` counter. ``nms_sweep`` is the entry point that drives them.
``head_conv.head_conv_kernel`` (the CPN heads' bf16 convolution, taken by
``models/commons.py: head_conv``) and ``selective_scan.selective_scan_kernel``
(the Mamba scan, taken by ``models/mamba.py: selective_scan``) count their
launches the same way.
"""
from .nms import nms_bits_count, nms_bits_fill, nms_resolve, nms_sweep

KERNELS = (nms_bits_count, nms_bits_fill, nms_resolve)

__all__ = ['nms_sweep', 'nms_bits_count', 'nms_bits_fill', 'nms_resolve', 'KERNELS']
