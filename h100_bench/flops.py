"""Frozen FLOP count of a configuration's forward: its convolutions and matmuls.

Counted on the reference itself at the cell's shapes, on the ``meta``
device (shapes only, nothing computed): 2 x output elements x the input
channels of a group x the kernel's taps for every convolution, 2 m n k for
every matrix product. Nothing else (norms, activations, the decode) counts.
"""
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .reference import cpn

_CONV = {torch.ops.aten.convolution.default}
_MM = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default}


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0
        self.by_shape = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _CONV:
            w = args[1]
            n = 2 * out.numel() * math.prod(w.shape[1:])
            self.by_shape.append((tuple(w.shape), tuple(out.shape), n))
            self.flops += n
        elif func in _MM:
            a, b = args[-2], args[-1]
            self.flops += 2 * math.prod(a.shape) * b.shape[-1]
        return out


def forward_flops(module, cfg: dict, batch: int, height: int, width: int):
    """FLOPs of one forward of ``batch`` NHWC images through the reference
    module's backbone and heads; also returns the per-convolution counts."""
    shapes = module.shapes(cfg)
    p = {k: torch.empty(s, device='meta') for k, s in shapes.items()}
    x = torch.empty(batch, height, width, cfg['in_channels'], device='meta')
    with _Counter() as counter:
        cpn.dense_forward(module, p, x, cfg, cpn.Precision('fp32'))
    return counter.flops, counter.by_shape
