"""Common tensor ops (NHWC at the public functions).

Counterpart of ``celldetection_tpu/ops/commons.py`` (``resize_bilinear``,
``resize_nearest``, ``equal_size``: lines 24-76; ``downsample_labels``:
79-101; ``process_scores``: 115-143). Models run NCHW internally and call
:func:`interpolate_nchw`.
"""
import torch
import torch.nn.functional as F

__all__ = ['interpolate_nchw', 'resize_bilinear', 'resize_nearest', 'equal_size',
           'downsample_labels', 'process_scores', 'clip']


def clip(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """``jnp.clip``: a clamp whose derivative is 1/2 at a bound (``clamp``'s is 1).

    The tie rule matters to gradients that must agree with the JAX package.
    """
    if lo is not None:
        x = torch.maximum(x, x.new_tensor(lo))
    if hi is not None:
        x = torch.minimum(x, x.new_tensor(hi))
    return x


def interpolate_nchw(x: torch.Tensor, size, mode: str = 'bilinear') -> torch.Tensor:
    """Resize the spatial dims of an NCHW tensor (no-op at equal size).

    ``'nearest'`` is torch's floor-of-scaled-index rule, as in the JAX
    package. ``'bilinear'`` uses half-pixel centres (``align_corners=False``),
    which equals ``jax.image.resize(method='linear')`` on an upscale; on a
    downscale (the score bounds of masked tiled inference, resized to the
    score map) JAX widens the triangle kernel by the scale, as
    ``F.interpolate(antialias=True)`` does (equal to 1 ulp on 0/1 masks).
    """
    size = tuple(int(s) for s in size)
    if tuple(x.shape[2:]) == size:
        return x
    if mode == 'nearest':
        return F.interpolate(x, size=size, mode='nearest')
    if mode != 'bilinear':
        raise ValueError(f'Unknown interpolation mode: {mode}')
    down = any(d < s for d, s in zip(size, x.shape[2:]))
    return F.interpolate(x, size=size, mode='bilinear', align_corners=False, antialias=down)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear NHWC resize matching torch ``align_corners=False``, antialiased on a downscale."""
    return interpolate_nchw(x.permute(0, 3, 1, 2), size, 'bilinear').permute(0, 2, 3, 1)


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """Nearest NHWC resize (``src = floor(dst * in / out)``)."""
    return interpolate_nchw(x.permute(0, 3, 1, 2), size, 'nearest').permute(0, 2, 3, 1)


def equal_size(x: torch.Tensor, reference: torch.Tensor, mode: str = 'bilinear') -> torch.Tensor:
    """Resize NHWC ``x`` to the spatial size of NHWC ``reference`` if needed."""
    if x.shape[1:3] == reference.shape[1:3]:
        return x
    size = reference.shape[1:3]
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
