"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

``KERNELS`` lists the launch wrappers; each carries a ``launches`` counter.
"""
from .nms import nms_sweep

KERNELS = (nms_sweep,)

__all__ = ['nms_sweep', 'KERNELS']
