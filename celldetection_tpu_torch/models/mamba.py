"""Mamba (selective state-space) token mixer.

Counterpart of ``celldetection_tpu/models/mamba.py``: ``selective_scan``
(19-43), ``Mamba`` (46-73) and ``MambaLayer`` (76-92). The JAX package
computes the scan with ``jax.lax.associative_scan``; here it is a log-depth
Hillis-Steele scan in plain torch (``ceil(log2 L)`` rounds over the whole
sequence written into two buffers in turn, no loop over the tokens), which
combines the same affine maps in another order, so the two agree to float32
rounding. Its backward is the same scan run from the end (``_LinearRecurrence``),
so autograd keeps two ``[B, L, D, N]`` tensors, not two a round.

Layouts and conventions follow the JAX package, not ``mamba_ssm``: Δ has
rank 1 (``x_proj`` gives ``2 d_state + 1`` outputs), ``dt_proj`` has a
bias, ``A = -exp(A_log)``, softplus is ``logaddexp(x, 0)``, and the norm is
flax's ``LayerNorm`` (epsilon 1e-6, statistics in float32). The causal
depthwise convolution is a ``Conv1d(groups=d_inner)`` after a left pad of
``d_conv - 1``.
"""
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ['selective_scan', 'Mamba', 'MambaLayer', 'FlaxLayerNorm']


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
    """
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
    """Mamba block: a gated selective-SSM token mixer over ``[B, L, d_model]``."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4, expand: int = 2):
        super().__init__()
        self.d_state, self.d_conv = d_state, d_conv
        d_inner = expand * d_model
        self.in_proj = nn.Linear(d_model, 2 * d_inner, bias=False)
        self.conv1d = nn.Conv1d(d_inner, d_inner, d_conv, groups=d_inner)
        self.x_proj = nn.Linear(d_inner, 2 * d_state + 1, bias=False)
        self.dt_proj = nn.Linear(1, d_inner)
        self.A_log = nn.Parameter(torch.log(torch.arange(1, d_state + 1, dtype=torch.float32)
                                            ).expand(d_inner, d_state).contiguous())
        self.D = nn.Parameter(torch.ones(d_inner))
        self.out_proj = nn.Linear(d_inner, d_model, bias=False)

    def forward(self, x):
        xs, z = self.in_proj(x).chunk(2, -1)
        # depthwise causal convolution over the sequence
        xs = self.conv1d(F.pad(xs.transpose(1, 2), (self.d_conv - 1, 0))).transpose(1, 2)
        xs = F.silu(xs)
        delta, Bm, Cm = self.x_proj(xs).split([1, self.d_state, self.d_state], -1)
        delta = self.dt_proj(delta)
        delta = torch.logaddexp(delta, torch.zeros_like(delta))      # jax.nn.softplus
        y = selective_scan(xs, delta, -torch.exp(self.A_log), Bm, Cm, self.D)
        return self.out_proj(y * F.silu(z))


class MambaLayer(nn.Module):
    """LayerNorm and Mamba over the flattened spatial positions of NC... input,
    added to it: a ``secondary_block`` of an encoder stage or a decoder level,
    built as ``MambaLayer(channels)``."""

    def __init__(self, channels: int, d_state: int = 16, d_conv: int = 4, expand: int = 2):
        super().__init__()
        self.norm = FlaxLayerNorm(channels)
        self.mamba = Mamba(channels, d_state, d_conv, expand)

    def forward(self, x):
        seq = x.flatten(2).transpose(1, 2)                   # [n, h*w, c], row-major positions
        out = seq + self.mamba(self.norm(seq))
        return out.transpose(1, 2).reshape(x.shape)
