"""Common tensor ops (NHWC at the public functions).

Counterpart of ``celldetection_tpu/ops/commons.py`` (``resize_bilinear``,
``resize_nearest``, ``equal_size``: lines 24-76; ``downsample_labels``:
79-101; ``process_scores``: 115-143; ``values2bins``, ``padded_stack2d``,
``split_spatially``, ``minibatch_std_layer``, ``strided_upsampling2d``,
``interpolate_vector``, ``pad_to_size``, ``pad_to_div``, ``spatial_mean``:
146-233). Models run NCHW internally and call :func:`interpolate_nchw`.
"""
import torch
import torch.nn.functional as F

__all__ = ['interpolate_nchw', 'resize_bilinear', 'resize_nearest', 'equal_size',
           'downsample_labels', 'process_scores', 'clip', 'values2bins', 'padded_stack2d',
           'split_spatially', 'minibatch_std_layer', 'strided_upsampling2d',
           'interpolate_vector', 'pad_to_size', 'pad_to_div', 'spatial_mean']


def clip(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """``jnp.clip``: a clamp whose derivative is 1/2 at a bound (``clamp``'s is 1).

    The tie rule matters to gradients that must agree with the JAX package.
    The bounds are 0-d tensors filled on ``x``'s device: one copied from a
    Python number would make the host wait for the card.
    """
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x


def interpolate_nchw(x: torch.Tensor, size, mode: str = 'bilinear') -> torch.Tensor:
    """Resize the spatial dims of an NC... tensor, 2-D or 3-D (no-op at equal size).

    ``'nearest'`` is torch's floor-of-scaled-index rule, as in the JAX
    package. ``'bilinear'`` (``'linear'`` and ``'trilinear'`` are the same
    here) uses half-pixel centres (``align_corners=False``), which equals
    ``jax.image.resize(method='linear')`` on an upscale; on a downscale (the
    score bounds of masked tiled inference, resized to the score map) JAX
    widens the triangle kernel by the scale, as ``F.interpolate(antialias=True)``
    does (equal to 1 ulp on 0/1 masks). torch antialiases only 2-D maps, so
    a 3-D map that shrinks along an axis is resized one axis at a time, as
    ``jax.image.resize`` is separable.
    """
    size = tuple(int(s) for s in size)
    if tuple(x.shape[2:]) == size:
        return x
    if mode == 'nearest':
        return F.interpolate(x, size=size, mode='nearest')
    if mode not in ('bilinear', 'linear', 'trilinear'):
        raise ValueError(f'Unknown interpolation mode: {mode}')
    down = any(d < s for d, s in zip(size, x.shape[2:]))
    if x.dim() == 4:
        return F.interpolate(x, size=size, mode='bilinear', align_corners=False, antialias=down)
    if not down:
        return F.interpolate(x, size=size, mode='trilinear', align_corners=False)
    for axis, target in enumerate(size, start=2):
        if x.shape[axis] != target:
            x = _linear_along(x, axis, target)
    return x


def _linear_along(x: torch.Tensor, axis: int, size: int) -> torch.Tensor:
    """``x`` resized linearly along one axis (antialiased on a downscale),
    as a 2-D resize of ``[M, 1, 1, L]`` rows."""
    moved = x.movedim(axis, -1)
    rows = moved.reshape(-1, 1, 1, moved.shape[-1])
    out = F.interpolate(rows, size=(1, size), mode='bilinear', align_corners=False,
                        antialias=size < moved.shape[-1])
    return out.reshape(moved.shape[:-1] + (size,)).movedim(-1, axis)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """(Bi/tri)linear channels-last resize of NHWC or NDHWC ``x`` matching
    torch ``align_corners=False``, antialiased on a downscale."""
    return interpolate_nchw(x.movedim(-1, 1), size, 'bilinear').movedim(1, -1)


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """Nearest channels-last resize of NHWC or NDHWC ``x`` (``src = floor(dst * in / out)``)."""
    return interpolate_nchw(x.movedim(-1, 1), size, 'nearest').movedim(1, -1)


def equal_size(x: torch.Tensor, reference: torch.Tensor, mode: str = 'bilinear') -> torch.Tensor:
    """Resize channels-last ``x`` to the spatial size of channels-last
    ``reference`` if needed (every spatial axis, 2-D or 3-D)."""
    if x.shape[1:-1] == reference.shape[1:-1]:
        return x
    size = reference.shape[1:-1]
    if mode == 'nearest':
        return resize_nearest(x, size)
    return resize_bilinear(x, size)


def downsample_labels(inputs: torch.Tensor, size) -> torch.Tensor:
    """Downsample ``[n, h, w]`` or ``[n, h, w, c]`` labels to ``size`` (h, w):
    max pooling by the integer factors, then nearest resizing to the exact
    size. Non-float labels become float32.
    """
    squeeze = inputs.dim() == 3
    x = inputs[..., None] if squeeze else inputs
    h, w = x.shape[1:3]
    th, tw = (int(s) for s in size)
    if (h, w) == (th, tw):
        return inputs
    if not x.is_floating_point():
        x = x.float()
    r = F.max_pool2d(x.permute(0, 3, 1, 2), (h // th, w // tw))
    r = interpolate_nchw(r, (th, tw), 'nearest').permute(0, 2, 3, 1)
    return r[..., 0] if squeeze else r


def _apply_score_bounds(scores, scores_lower_bound, scores_upper_bound):
    if scores_upper_bound is not None:
        scores = torch.minimum(scores, equal_size(scores_upper_bound, scores))
    if scores_lower_bound is not None:
        scores = torch.maximum(scores, equal_size(scores_lower_bound, scores))
    return scores


def process_scores(scores: torch.Tensor, score_channels: int, score_thresh,
                   scores_lower_bound=None, scores_upper_bound=None):
    """Raw score logits ``[n, h, w, c]`` → ``(probabilities, classes int32 [n, h, w])``.

    1 channel: sigmoid, classes = p > thresh; 2 channels: softmax foreground
    probability, classes = p_fg > thresh; more: softmax, classes = argmax.
    """
    bounds = (scores_lower_bound, scores_upper_bound)
    if score_channels == 1:
        scores = _apply_score_bounds(torch.sigmoid(scores), *bounds)
        classes = (scores[..., 0] > score_thresh).to(torch.int32)
    elif score_channels == 2:
        scores = _apply_score_bounds(torch.softmax(scores, -1)[..., 1:2], *bounds)
        classes = (scores[..., 0] > score_thresh).to(torch.int32)
    elif score_channels > 2:
        scores = _apply_score_bounds(torch.softmax(scores, -1), *bounds)
        classes = torch.argmax(scores, -1).to(torch.int32)
    else:
        raise ValueError(f'Invalid score_channels: {score_channels}')
    return scores, classes


def values2bins(values: torch.Tensor, limits, bins: int) -> torch.Tensor:
    """Quantise values in ``limits`` into ``bins`` int32 bins (floor division
    and remainder with Python's signs, as ``jnp``'s ``//`` and ``%``)."""
    mi, ma = limits
    v = (values - mi) / (ma - mi)
    return torch.remainder(torch.div(v, 1.0 / bins, rounding_mode='floor'), bins).to(torch.int32)


def padded_stack2d(*images, dim: int = 0) -> torch.Tensor:
    """Stack tensors, zero-padding their last two dims at the end to the largest extent."""
    ts = tuple(max(i.shape[j] for i in images) for j in range(-2, 0))
    padded = [F.pad(i, (0, ts[1] - i.shape[-1], 0, ts[0] - i.shape[-2])) for i in images]
    return torch.stack(padded, dim)


def split_spatially(x: torch.Tensor, size) -> torch.Tensor:
    """NHWC ``[n, h, w, c]`` → patches ``[n * h // ph * w // pw, ph, pw, c]``, row-major per image."""
    n, h, w, c = x.shape
    ph, pw = size
    x = x.reshape(n, h // ph, ph, w // pw, pw, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ph, pw, c)


def minibatch_std_layer(x: torch.Tensor, channels: int = 1, group_channels: int = None,
                        epsilon: float = 1e-8) -> torch.Tensor:
    """Minibatch standard-deviation layer (NHWC; ProGAN, arXiv:1710.10196):
    ``channels`` maps of the mean standard deviation over groups of the batch,
    appended to the channels. Batch element ``b`` belongs to group ``b % g``."""
    n, h, w, c = x.shape
    gc = min(group_channels or n, n)
    cc, g = c // channels, n // gc
    y = x.reshape(gc, g, h, w, channels, cc)
    y = torch.sqrt(y.var(0, unbiased=False) + epsilon).mean((1, 2, 4), keepdim=True)[..., 0]
    y = y[None].expand(gc, g, h, w, channels).reshape(n, h, w, channels)
    return torch.cat([x, y], -1)


def strided_upsampling2d(x: torch.Tensor, factor: int = 2, const: float = 0) -> torch.Tensor:
    """Upsample NHWC by ``factor``, the new rows and columns filled with ``const``."""
    n, h, w, c = x.shape
    out = torch.full((n, h * factor, w * factor, c), const, dtype=x.dtype, device=x.device)
    out[:, ::factor, ::factor] = x
    return out


def interpolate_vector(v: torch.Tensor, size: int, method: str = 'linear') -> torch.Tensor:
    """A 1-D tensor resized to ``size`` entries as ``jax.image.resize`` does:
    ``'linear'`` with half-pixel centres (antialiased on a downscale),
    ``'nearest'`` at the half-pixel centres' nearest entries."""
    x = v[None, None, None, :]
    if method in ('linear', 'bilinear'):
        return interpolate_nchw(x.float(), (1, size), 'bilinear')[0, 0, 0].to(v.dtype)
    if method == 'nearest':
        return F.interpolate(x, size=(1, size), mode='nearest-exact')[0, 0, 0]
    raise ValueError(f'interpolate_vector: method {method!r} is not ported (linear, nearest)')


def pad_to_size(v: torch.Tensor, size, return_pad: bool = False, constant_values=0):
    """Pad the trailing ``len(size)`` dims of ``v`` at their end up to ``size``
    with ``constant_values`` (the pad is returned as ``jnp.pad``'s list of pairs)."""
    pad = [(0, 0)] * (v.dim() - len(size))
    for a, b in zip(size, v.shape[v.dim() - len(size):]):
        pad.append((0, max(0, a - b)))
    out = v
    if any(p for _, p in pad):
        flat = [x for lo_hi in reversed(pad) for x in lo_hi]
        out = F.pad(v, flat, value=constant_values)
    return (out, pad) if return_pad else out


def pad_to_div(v: torch.Tensor, div: int = 32, nd: int = 2, return_pad: bool = False, **kwargs):
    """Pad the trailing ``nd`` dims at their end to multiples of ``div``."""
    if not isinstance(div, (tuple, list)):
        div = (div,) * nd
    size = [(i // d + bool(i % d)) * d for i, d in zip(v.shape[v.dim() - len(div):], div)]
    return pad_to_size(v, size, return_pad=return_pad, **kwargs)


def spatial_mean(x: torch.Tensor, keepdims: bool = False) -> torch.Tensor:
    """Mean over the spatial dims of a channels-last tensor (dims 1 to ndim - 2)."""
    return x.mean(tuple(range(1, x.dim() - 1)), keepdim=keepdims)
