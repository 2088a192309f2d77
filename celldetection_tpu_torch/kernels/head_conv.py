"""The CPN heads' bf16 K x K convolution as a hand-written Hopper kernel (``csrc/head_conv.cu``).

A stride-1, zero-padded ("same") 2-D convolution of channels-last bf16 input
as an implicit GEMM on the tensor cores (``wgmma``, fed by TMA); the source
explains its design and its bound on this card. It replaces no TPU kernel:
the JAX package leaves this convolution to XLA. :func:`takes` decides when
the heads (``models/commons.py: head_conv``) take it.

:func:`head_conv_kernel` runs :func:`head_conv_plain` for a CPU tensor and
launches the kernel for a CUDA tensor; there is no fallback from one to the
other. Each launch adds 1 to ``build.LAUNCHES['cdt_head_conv']``.
"""
import ctypes
import functools

import torch
import torch.nn.functional as F

from .build import KernelLibrary, launch, load

__all__ = ['head_conv_kernel', 'head_conv_plain', 'head_conv_library', 'takes']

_P = ctypes.c_void_p
_I = ctypes.c_int
# Input channels a step of the kernel's depth, and its tile of 8 x 16 output
# pixels and 64 output channels at least: the grid's tile count must fit an int.
_CHANNELS = 64
_TILE = (8, 16)


@functools.cache
def head_conv_library() -> KernelLibrary:
    """Build (at first use) and load ``csrc/head_conv.cu``."""
    return load('head_conv.cu', {'cdt_head_conv': [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]},
                libraries=('cuda',))


def head_conv_plain(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor = None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, on any device.

    The bf16 operands' products are exact in fp32 and summed in fp32 (TF32
    off), the bias is added in fp32, and the sum is rounded once to bf16.

    Returns:
        ``[B, Cout, H, W]`` bf16, channels-last.
    """
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv2d(x.float(), weight.float(), None if bias is None else bias.float(),
                     padding=weight.shape[-1] // 2)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return y.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)


def takes(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor = None, stride=1,
          padding=None) -> bool:
    """Whether the kernel computes ``F.conv2d(x, weight, bias, stride, padding)``.

    That is ``x`` on a CUDA card, no gradient wanted (grad mode off, or no
    operand requires grad), and operands that :func:`_fits`.
    """
    return (x.is_cuda and _fits(x, weight, bias, stride, padding)
            and not (torch.is_grad_enabled()
                     and any(t is not None and t.requires_grad for t in (x, weight, bias))))


def _fits(x, weight, bias, stride, padding) -> bool:
    """A 2-D convolution of bf16 operands (and a bf16 bias or none, as
    ``F.conv2d`` asks), stride 1, "same" padding K // 2 of a square, odd K,
    input and output channels multiples of 64, and few enough tiles for the
    grid's int."""
    if x.dim() != 4 or weight.dim() != 4:
        return False
    bsz, cin, h, w = x.shape
    cout, wcin, kh, kw = weight.shape
    return (x.dtype == torch.bfloat16 and weight.dtype == torch.bfloat16
            and (bias is None or bias.dtype == torch.bfloat16)
            and stride in (1, (1, 1)) and kh == kw and kh % 2 == 1
            and padding in (kh // 2, (kh // 2, kh // 2))
            and wcin == cin and min(cin, cout) > 0
            and cin % _CHANNELS == 0 and cout % _CHANNELS == 0
            and bsz * -(-h // _TILE[0]) * -(-w // _TILE[1]) * (cout // _CHANNELS) < 2 ** 31)


def head_conv_kernel(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor = None) -> torch.Tensor:
    """``F.conv2d(x, weight, bias, padding=K // 2)`` of bf16 operands, rounded once to bf16.

    Args:
        x: ``[B, Cin, H, W]`` bf16; channels-last saves a copy.
        weight: ``[Cout, Cin, K, K]`` bf16, K odd; Cin and Cout multiples of 64.
        bias: ``[Cout]`` bf16, or None.

    Returns:
        ``[B, Cout, H, W]`` bf16, channels-last.
    """
    if x.device.type == 'cpu':
        return head_conv_plain(x, weight, bias)
    if x.device.type != 'cuda' or weight.device != x.device or \
            (bias is not None and bias.device != x.device):
        raise ValueError('head_conv_kernel: x, weight and bias on one CUDA device')
    if not _fits(x, weight, bias, 1, weight.shape[-1] // 2):
        raise ValueError(f'head_conv_kernel: input {tuple(x.shape)} {x.dtype} and weight '
                         f'{tuple(weight.shape)} {weight.dtype}: bf16 operands, Cin and Cout '
                         f'multiples of 64, one odd K')
    bsz, cin, h, w = x.shape
    cout, _, k, _ = weight.shape
    if not bsz * h * w:                # nothing to launch
        return torch.empty(bsz, h, w, cout, dtype=torch.bfloat16,
                           device=x.device).permute(0, 3, 1, 2)
    xs = x.contiguous(memory_format=torch.channels_last)
    if xs.data_ptr() % 16:   # TMA reads from 16-byte aligned addresses
        xs = xs.clone(memory_format=torch.channels_last)
    wt = weight.permute(0, 2, 3, 1).contiguous()          # [Cout, K, K, Cin]: depth innermost
    # a fresh fp32 copy: the kernel reads it two floats at a time, 8-byte aligned
    b = (torch.zeros(cout, dtype=torch.float32, device=x.device) if bias is None
         else bias.to(torch.float32, copy=True))
    out = torch.empty(bsz, h, w, cout, dtype=torch.bfloat16, device=x.device)
    launch(head_conv_library(), 'cdt_head_conv', x.device, xs.data_ptr(), wt.data_ptr(),
           b.data_ptr(), out.data_ptr(), bsz, h, w, cin, cout, k)
    return out.permute(0, 3, 1, 2)
