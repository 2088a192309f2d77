"""The Mamba selective scan as one fused Hopper kernel (``csrc/selective_scan.cu``).

``y_t = C_t · s_t + D u_t`` with ``s_t = exp(Δ_t A) s_{t-1} + Δ_t B_t u_t``
from ``s = 0``, every state kept in registers along the tokens, in fp32. It
replaces no TPU kernel: the JAX package computes the scan with
``jax.lax.associative_scan``. The exponentials and then the bytes of u, Δ, B,
C and y bound it; the source says how its design (chunks of tokens scanned
twice around a short pass that carries the states across them) answers.
:func:`takes` decides when the model (``models/mamba.py: selective_scan``)
takes it.

:func:`selective_scan_kernel` launches the kernel where :func:`takes` holds
and raises otherwise; there is no fallback. Each call that launches adds 1 to
``build.LAUNCHES['cdt_selective_scan']`` (three kernels a call, one where the
tokens fit one chunk).
:func:`selective_scan_plain` repeats the kernel's chunked arithmetic in plain
PyTorch, on any device.
"""
import ctypes
import functools

import torch
import torch.nn.functional as F

from .build import KernelLibrary, launch, load

__all__ = ['selective_scan_kernel', 'selective_scan_plain', 'selective_scan_library', 'takes',
           'chunk_tokens', 'exp2_plain', 'STATES', 'EXP2_POLY']

_P = ctypes.c_void_p
_I = ctypes.c_int
_THREADS = 128      # channels a block
_CHUNK = 32         # the least chunk, a multiple of the kernel's 16-token tile
_BLOCKS = 1024      # blocks a launch aims at: on the H100, fewer and longer chunks than
                    # 2048 blocks shorten the carry pass more than they cost the scans
_GRID = 65535       # the grid's y and z limits: chunks, images
STATES = (4, 8, 16)  # state sizes the kernel is built for
LOG2E = 1.4426950408889634
# 2^f on [-1/2, 1/2], highest power first: the kernel's polynomial (csrc: exp2_poly)
EXP2_POLY = (1.5337577497120947e-4, 1.3399859890341759e-3, 9.618519805371761e-3,
             5.550329014658928e-2, 2.4022646248340607e-1, 6.931471824645996e-1, 1.)


@functools.cache
def selective_scan_library() -> KernelLibrary:
    """Build (at first use) and load ``csrc/selective_scan.cu``."""
    return load('selective_scan.cu', {
        'cdt_selective_scan': [_P] * 9 + [ctypes.POINTER(ctypes.c_longlong)] + [_I] * 5 + [_P]})


def chunk_tokens(batch: int, tokens: int, d_inner: int) -> int:
    """Tokens a chunk of the kernel: the least of 32, 64, 128, ... that leaves
    at most 1024 blocks of 128 channels (or one chunk) and at most 65,535 chunks."""
    per_chunk = batch * -(-d_inner // _THREADS)
    chunk = _CHUNK
    while chunk < tokens and (-(-tokens // chunk) * per_chunk > _BLOCKS
                              or -(-tokens // chunk) > _GRID):
        chunk *= 2
    return chunk


def takes(u, delta, A, B, C, D) -> bool:
    """Whether the kernel computes ``selective_scan(u, delta, A, B, C, D)``.

    That is fp32 operands on one CUDA device, no gradient wanted (grad mode
    off, or no operand requires grad), ``u`` and ``delta`` ``[batch, tokens,
    d_inner]``, ``A`` ``[d_inner, N]`` with N 4, 8 or 16, ``B`` and ``C``
    ``[batch, tokens, N]``, ``D`` ``[d_inner]``, and at most 65,535 images;
    any strides.
    """
    operands = (u, delta, A, B, C, D)
    if u.dim() != 3 or A.dim() != 2:
        return False
    batch, tokens, d_inner = u.shape
    n = A.shape[1]
    return (u.is_cuda and all(t.device == u.device for t in operands)
            and all(t.dtype == torch.float32 for t in operands)
            and not (torch.is_grad_enabled() and any(t.requires_grad for t in operands))
            and tuple(delta.shape) == (batch, tokens, d_inner) and tuple(A.shape) == (d_inner, n)
            and n in STATES and tuple(B.shape) == tuple(C.shape) == (batch, tokens, n)
            and tuple(D.shape) == (d_inner,) and batch <= _GRID)


def exp2_plain(x: torch.Tensor) -> torch.Tensor:
    """2^x as the kernel takes it: x clamped at -125 and rounded to an integer
    j (half to even), 2^(x - j) by :data:`EXP2_POLY` in Horner's order, times
    2^j. In fp32 within 1.3 ulp of 2^x, and unbiased (MUFU.EX2, the card's
    ``exp2f``, is not: a state that multiplies thousands of gains near 1
    drifts with it)."""
    x = x.clamp(min=-125.)
    j = torch.round(x)
    f = x - j
    p = torch.full_like(f, EXP2_POLY[0])
    for c in EXP2_POLY[1:]:
        p = p * f + c
    return torch.ldexp(p, j)


def selective_scan_plain(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                         C: torch.Tensor, D: torch.Tensor, chunk: int = None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, on any device and dtype.

    The tokens in chunks of ``chunk`` (by default :func:`chunk_tokens`'s):
    (1) each chunk scanned from a zero state, its Δ summed token by token;
    (2) the states carried across the chunks in order, each through its
    chunk's whole decay ``2^(A log2(e) ΣΔ)``; (3) each chunk scanned again from
    its carry-in, ``y`` contracted with C and ``D u`` added. A decay is
    ``2^(Δ A log2(e))`` by :func:`exp2_plain`, ``A log2(e)`` rounded once to
    the operands' type.
    The chunks are padded with Δ = 0 tokens, which leave a state as it is.

    Returns:
        ``[batch, tokens, d_inner]``.
    """
    batch, tokens, d_inner = u.shape
    if not tokens:
        return u * D
    if chunk is None:
        chunk = chunk_tokens(batch, tokens, d_inner)
    chunks = -(-tokens // chunk)
    pad = chunks * chunk - tokens

    def by_chunk(t):                                           # [b, chunks, chunk, ...]
        return F.pad(t, (0, 0, 0, pad)).reshape(batch, chunks, chunk, t.shape[-1])

    dt, uc, bc, cc = by_chunk(delta), by_chunk(u), by_chunk(B), by_chunk(C)
    a2 = A * LOG2E

    def step(s, t):
        gain = exp2_plain(dt[:, :, t, :, None] * a2)
        drive = (dt[:, :, t] * uc[:, :, t])[..., None] * bc[:, :, t, None, :]
        return torch.addcmul(drive, gain, s)

    s = u.new_zeros(batch, chunks, d_inner, A.shape[1])
    total = u.new_zeros(batch, chunks, d_inner)
    for t in range(chunk):                                     # (1) from zero states
        s = step(s, t)
        total = total + dt[:, :, t]
    carry = u.new_zeros(batch, d_inner, A.shape[1])
    starts = [carry]
    for k in range(chunks - 1):                                # (2) across the chunks
        carry = torch.addcmul(s[:, k], exp2_plain(a2 * total[:, k, :, None]), carry)
        starts.append(carry)
    s = torch.stack(starts, 1)
    ys = []
    for t in range(chunk):                                     # (3) from the carry-ins
        s = step(s, t)
        ys.append((s * cc[:, :, t, None, :]).sum(-1))
    y = torch.stack(ys, 2).reshape(batch, chunks * chunk, d_inner)[:, :tokens]
    return y + u * D


def selective_scan_kernel(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                          C: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """``models/mamba.py: selective_scan`` on the card, fused: the operands as
    :func:`takes` asks (read by their strides), ``y`` ``[batch, tokens,
    d_inner]`` fp32, contiguous."""
    if not takes(u, delta, A, B, C, D):
        raise ValueError(
            f'selective_scan_kernel: u {tuple(u.shape)} {u.dtype} on {u.device}, A '
            f'{tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}: fp32 operands on one '
            f'CUDA device, no gradient wanted, u and delta [batch, tokens, d_inner], A '
            f'[d_inner, N] with N in {STATES}, B and C [batch, tokens, N], D [d_inner]')
    batch, tokens, d_inner = u.shape
    n = A.shape[1]
    y = torch.empty(batch, tokens, d_inner, dtype=torch.float32, device=u.device)
    if not y.numel():                  # nothing to launch
        return y
    chunk = chunk_tokens(batch, tokens, d_inner)
    links = -(-tokens // chunk) - 1
    carry = torch.empty(batch, links, d_inner, n, dtype=torch.float32, device=u.device)
    sumdt = torch.empty(batch, links, d_inner, dtype=torch.float32, device=u.device)
    strides = (ctypes.c_longlong * 15)(*u.stride(), *delta.stride(), *B.stride(), *C.stride(),
                                       *A.stride(), *D.stride())
    launch(selective_scan_library(), 'cdt_selective_scan', u.device, u.data_ptr(),
           delta.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(),
           carry.data_ptr(), sumdt.data_ptr(), y.data_ptr(), strides, batch, tokens, d_inner, n,
           chunk)
    return y
