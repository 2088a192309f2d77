"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

``nms.nms_sweep`` drives the NMS kernels (``nms_bits_count``,
``nms_bits_fill``, ``nms_resolve``); ``head_conv.head_conv_kernel`` is the
CPN heads' bf16 convolution and ``selective_scan.selective_scan_kernel`` the
Mamba scan. Each module's ``takes`` (or the NMS wrappers' device) decides
whether a call takes its kernel. ``build`` holds the one way to build and
load a kernel (``build.load``), launch it (``build.launch``) and count its
launches (``LAUNCHES``, keyed by C entry). This package imports nothing of
the port above ``util``.
"""
from .build import LAUNCHES
from .nms import nms_bits_count, nms_bits_fill, nms_resolve, nms_sweep

__all__ = ['nms_sweep', 'nms_bits_count', 'nms_bits_fill', 'nms_resolve', 'LAUNCHES']
