"""Mamba (selective state-space) token mixer.

Counterpart of ``celldetection_tpu/models/mamba.py``: ``selective_scan``
(19-43), ``Mamba`` (46-73) and ``MambaLayer`` (76-92). The JAX package
computes the scan with ``jax.lax.associative_scan``. Here, on a CUDA card with
fp32 operands and no gradient wanted, it is one fused hand-written kernel that
keeps the states in registers (``kernels/selective_scan.py``); everywhere else
(training, bf16, the CPU) it is a log-depth Hillis-Steele scan in plain torch
(``ceil(log2 L)`` rounds over the whole sequence written into two buffers in
turn, no loop over the tokens). Both combine the same affine maps in another
order than the JAX package, so they agree with it to float32 rounding. The
torch scan's backward is the same scan run from the end
(``_LinearRecurrence``), so autograd keeps two ``[B, L, D, N]`` tensors, not
two a round.

Layouts and conventions follow the JAX package, not ``mamba_ssm``:
``dt_proj`` has a bias, ``A = -exp(A_log)``, softplus is ``logaddexp(x, 0)``,
and the norm is flax's ``LayerNorm`` (epsilon 1e-6, statistics in float32).
The causal depthwise convolution is a ``Conv1d(groups=d_inner)`` after a
left pad of ``d_conv - 1``. Δ's rank ``dt_rank`` defaults to 1, the JAX
package's (``x_proj`` gives ``2 d_state + 1`` outputs, ``dt_proj`` is
``Linear(1, d_inner)``); ``dt_rank='auto'`` is ``mamba_ssm``'s,
``ceil(d_model / 16)``.

Spans (:mod:`..util.spans`): ``mamba.layer`` over ``MambaLayer.forward``
(counts ``batch``, ``tokens``, ``d_model``, ``d_inner``, ``d_state``,
``dt_rank``) holds ``mamba.scan`` over the call of :func:`selective_scan`
(``batch``, ``tokens``, ``d_inner``, ``d_state``, ``elem_bytes`` of ``u``;
``kernel`` 1 and ``launches`` 1 where the call ran on the fused kernel, both
left out on the torch path).
"""
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.selective_scan import selective_scan_kernel, takes as kernel_takes
from ..util.spans import count, span

__all__ = ['selective_scan', 'Mamba', 'MambaLayer', 'FlaxLayerNorm']


def resolve_dt_rank(dt_rank, d_model: int) -> int:
    """Δ's rank: an int as it is, ``'auto'`` ``ceil(d_model / 16)`` (``mamba_ssm``'s)."""
    if dt_rank == 'auto':
        return math.ceil(d_model / 16)
    if isinstance(dt_rank, bool) or not isinstance(dt_rank, int) or dt_rank < 1:
        raise ValueError(f"dt_rank must be a positive int or 'auto', not {dt_rank!r}")
    return dt_rank


def _affine_scan(gain: torch.Tensor, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Compose the affine maps ``s -> gain_t s + x_t`` along axis 1 from the
    first token (from the last when ``reverse``): the state after each token,
    from a zero state. ``ceil(log2 L)`` Hillis-Steele rounds, each written
    into the other of two buffers (the arguments are not written); no
    autograd."""
    length = x.shape[1]
    xs, gains = (torch.empty_like(x), torch.empty_like(x)), (torch.empty_like(gain),
                                                              torch.empty_like(gain))
    step, i = 1, 0
    while step < length:
        # each token takes the map ``step`` tokens before it (after it when
        # ``reverse``); the ``step`` tokens at the start (end) are done
        done, dst, src = ((slice(-step, None), slice(None, -step), slice(step, None)) if reverse
                          else (slice(None, step), slice(step, None), slice(None, -step)))
        xs[i][:, done] = x[:, done]
        torch.addcmul(x[:, dst], gain[:, dst], x[:, src], out=xs[i][:, dst])
        x = xs[i]
        if 2 * step < length:
            gains[i][:, done] = gain[:, done]
            torch.mul(gain[:, dst], gain[:, src], out=gains[i][:, dst])
            gain = gains[i]
        step, i = 2 * step, 1 - i
    return x


class _LinearRecurrence(torch.autograd.Function):
    """``x_t = gain_t x_{t-1} + b_t`` from ``x_{-1} = 0``. The backward is the
    same scan in reverse: the adjoint ``l_t = g_t + gain_{t+1} l_{t+1}``
    gives ``db_t = l_t`` and ``dgain_t = l_t x_{t-1}``."""

    @staticmethod
    def forward(ctx, gain, b):
        x = _affine_scan(gain, b)
        ctx.save_for_backward(gain, x)
        return x

    @staticmethod
    def backward(ctx, g):
        gain, x = ctx.saved_tensors
        adjoint = _affine_scan(F.pad(gain[:, 1:], (0, 0, 0, 0, 0, 1)), g.contiguous(), reverse=True)
        return adjoint * F.pad(x[:, :-1], (0, 0, 0, 0, 1, 0)), adjoint


def selective_scan(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """Selective SSM scan: ``x_t = exp(Δ_t A) x_{t-1} + Δ_t B_t u_t``, ``y_t = C_t x_t + D u_t``.

    Args:
        u: ``[B, L, D]`` input sequence.
        delta: ``[B, L, D]`` positive step sizes.
        A: ``[D, N]`` state matrix (diagonal, negative real).
        B, C: ``[B, L, N]`` input and output projections.
        D: ``[D]`` skip gain.

    Returns:
        ``[B, L, D]``.

    Where the operands show that the fused kernel computes it
    (:func:`..kernels.selective_scan.takes`: fp32 on a CUDA card, no gradient
    wanted, d_state 4, 8 or 16) the kernel runs and counts ``kernel`` on the
    innermost recording span (``mamba.scan``); else :func:`selective_scan_torch`.
    """
    if kernel_takes(u, delta, A, B, C, D):
        count('kernel')
        return selective_scan_kernel(u, delta, A, B, C, D)
    return selective_scan_torch(u, delta, A, B, C, D)


def selective_scan_torch(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                         C: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """:func:`selective_scan` as the log-depth torch scan, on any device and
    dtype, with a backward: ``[B, L, D, N]`` gains and inputs, their
    recurrence by :func:`_affine_scan`, the contraction with C."""
    gain = torch.exp(delta[..., None] * A)                       # [B, L, D, N]
    x = _LinearRecurrence.apply(gain, delta[..., None] * B[..., None, :] * u[..., None])
    y = torch.einsum('bln,bldn->bld', C, x)
    return y + u * D


class FlaxLayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: epsilon 1e-6, the mean and
    ``E[x^2] - E[x]^2`` in float32, the result cast back to the input's type."""

    def __init__(self, num_features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp(xf.square().mean(-1, keepdim=True) - mean.square(), min=0.)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight.float()) + self.bias.float()
        return y.to(x.dtype)


class Mamba(nn.Module):
    """Mamba block: a gated selective-SSM token mixer over ``[B, L, d_model]``;
    Δ of rank ``dt_rank`` (an int or ``'auto'``, see :func:`resolve_dt_rank`)."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4, expand: int = 2,
                 dt_rank=1):
        super().__init__()
        self.d_state, self.d_conv = d_state, d_conv
        self.dt_rank = resolve_dt_rank(dt_rank, d_model)
        d_inner = self.d_inner = expand * d_model
        self.in_proj = nn.Linear(d_model, 2 * d_inner, bias=False)
        self.conv1d = nn.Conv1d(d_inner, d_inner, d_conv, groups=d_inner)
        self.x_proj = nn.Linear(d_inner, self.dt_rank + 2 * d_state, bias=False)
        self.dt_proj = nn.Linear(self.dt_rank, d_inner)
        self.A_log = nn.Parameter(torch.log(torch.arange(1, d_state + 1, dtype=torch.float32)
                                            ).expand(d_inner, d_state).contiguous())
        self.D = nn.Parameter(torch.ones(d_inner))
        self.out_proj = nn.Linear(d_inner, d_model, bias=False)

    def forward(self, x):
        xs, z = self.in_proj(x).chunk(2, -1)
        # depthwise causal convolution over the sequence
        xs = self.conv1d(F.pad(xs.transpose(1, 2), (self.d_conv - 1, 0))).transpose(1, 2)
        xs = F.silu(xs)
        delta, Bm, Cm = self.x_proj(xs).split([self.dt_rank, self.d_state, self.d_state], -1)
        delta = self.dt_proj(delta)
        delta = torch.logaddexp(delta, torch.zeros_like(delta))      # jax.nn.softplus
        batch, tokens = xs.shape[:2]
        with span('mamba.scan', batch=batch, tokens=tokens, d_inner=self.d_inner,
                  d_state=self.d_state, elem_bytes=xs.element_size()):
            y = selective_scan(xs, delta, -torch.exp(self.A_log), Bm, Cm, self.D)
        return self.out_proj(y * F.silu(z))


class MambaLayer(nn.Module):
    """LayerNorm and Mamba over the flattened spatial positions of NC... input,
    added to it: a ``secondary_block`` of an encoder stage or a decoder level,
    built as ``MambaLayer(channels)`` (or a ``functools.partial`` of it with
    its options)."""

    def __init__(self, channels: int, d_state: int = 16, d_conv: int = 4, expand: int = 2,
                 dt_rank=1):
        super().__init__()
        self.norm = FlaxLayerNorm(channels)
        self.mamba = Mamba(channels, d_state, d_conv, expand, dt_rank)

    def forward(self, x):
        m = self.mamba
        with span('mamba.layer', batch=x.shape[0], tokens=math.prod(x.shape[2:]),
                  d_model=x.shape[1], d_inner=m.d_inner, d_state=m.d_state, dt_rank=m.dt_rank):
            seq = x.flatten(2).transpose(1, 2)               # [n, h*w, c], row-major positions
            out = seq + m(self.norm(seq))
            return out.transpose(1, 2).reshape(x.shape)
