"""Contour outlines rasterised on a tensor canvas, on its device.

Counterpart of ``celldetection_tpu/ops/draw.py``: each segment of each
contour is sampled at ``steps_per_segment`` points, ``t`` from 0 to 1 as
``jnp.linspace`` makes it in float32 (the step ``i * (1 / (n - 1))``, whose
values differ from ``torch.linspace``'s by an ulp in places, enough to move a
rounded point to the next pixel), the points rounded half to even, and all
of them written in one scatter, with no loop over contours.

Where writes meet, the last one in flat ``(contour, point, step)`` order
wins, as XLA's scatter on the CPU applies duplicate indices in order:
``scatter_reduce('amax')`` of each write's flat position per pixel picks the
winner, then its value is gathered, so the result is the same on the CPU and
on a card (``index_put_`` on CUDA leaves the order of duplicates open).
Writes of invalid contours go to a scratch slot past the canvas.
"""
import numpy as np
import torch

__all__ = ['draw_contours', 'draw_contours_']


def _unit_steps(n: int, device) -> torch.Tensor:
    """``jnp.linspace(0., 1., n)`` in float32."""
    if n == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    t = np.arange(n, dtype=np.float32) * (np.float32(1) / np.float32(n - 1))
    t[-1] = 1.
    return torch.from_numpy(t).to(device)


def draw_contours_(canvas: torch.Tensor, contours: torch.Tensor, val=None,
                   valid: torch.Tensor = None, close: bool = True,
                   steps_per_segment: int = 16) -> torch.Tensor:
    """Draw contour outlines into ``canvas`` in place; returns it.

    Args:
        canvas: ``[h, w]`` tensor (any device).
        contours: ``[num_contours, num_points, 2]`` (x, y) coordinates.
        val: Scalar or ``[num_contours]`` values; the contour index + 1 by default.
        valid: Optional bool ``[num_contours]``; invalid contours draw nothing.
        close: Connect the last point to the first.
        steps_per_segment: Samples per segment; at least the longest segment
            in pixels for lines without gaps.
    """
    h, w = canvas.shape
    dev = canvas.device
    contours = torch.as_tensor(contours, device=dev)
    n, p, _ = contours.shape
    if val is None:
        val = torch.arange(1, n + 1, device=dev).to(canvas.dtype)
    val = torch.as_tensor(val, device=dev).to(canvas.dtype).broadcast_to((n,))
    a = contours.float()
    b = a.roll(-1, dims=1) if close else torch.cat([a[:, 1:], a[:, -1:]], 1)
    t = _unit_steps(steps_per_segment, dev)[None, None, :, None]
    pts = a[:, :, None, :] * (1 - t) + b[:, :, None, :] * t       # [n, p, steps, 2]
    xi = pts[..., 0].round().to(torch.int64).clamp(0, w - 1)
    yi = pts[..., 1].round().to(torch.int64).clamp(0, h - 1)
    idx = (yi * w + xi).reshape(-1)
    if valid is not None:
        keep = torch.as_tensor(valid, device=dev)[:, None, None].expand(xi.shape).reshape(-1)
        idx = torch.where(keep, idx, h * w)
    pos = torch.arange(idx.numel(), device=dev)
    winner = torch.full((h * w + 1,), -1, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(0, idx, pos, 'amax')
    winner = winner[:h * w]
    hit = winner >= 0
    vals = val[:, None, None].expand(xi.shape).reshape(-1)
    flat = canvas.view(-1)
    flat[hit] = vals[winner[hit]]
    return canvas


def draw_contours(canvas: torch.Tensor, contours: torch.Tensor, val=None,
                  valid: torch.Tensor = None, close: bool = True,
                  steps_per_segment: int = 16) -> torch.Tensor:
    """:func:`draw_contours_` on a copy of ``canvas``; returns the copy."""
    return draw_contours_(canvas.clone(), contours, val=val, valid=valid, close=close,
                          steps_per_segment=steps_per_segment)
