"""Contour Proposal Network: inference and training (PyTorch).

Counterpart of ``celldetection_tpu/models/cpn.py``: ``CPNCore`` (69-187),
``_gather_hw`` (194-211), ``local_refinement`` (214-253), ``cpn_decode``
(256-356) and ``apply_detection_offsets`` (359-372), ``DEFAULT_WEIGHTS`` and
``cpn_compute_loss`` (375-478), ``CPN`` (508-579) with ``forward_padded``
(614-693, with and without targets),
``prepare_inputs`` (708-739), ``__call__`` (741-783, here ``forward``, which
sends inputs above ``max_imsize`` through
:class:`..parallel.tiles.TiledInference`) and ``detach`` (785-806),
``CpnU22`` (834-846), ``CpnSlimU22``, ``CpnWideU22``, ``CpnResUNet``,
``CpnU17`` and ``CpnU12`` (849-884), every constructor of
``_register_backbone_cpns`` (887-1046: the twenty ResNet-family UNets and
FPNs, the ConvNeXt, DenseNet and MobileNetV3 UNets, the MobileNetV3 FPNs,
the ResNet MaNets, the Timm/Smp UNets and MaNets and ``CpnMiTB5MaNet``) and
``get_cpn``. ``backbone_kwargs={'pretrained': spec}`` loads ImageNet
encoder weights after the init (:func:`..util.pretrained.apply_pretrained_`),
as the JAX package's ``CPN.init`` does.

As in the JAX package every selection is capacity-padded: per image the top
``max_detections`` foreground pixels are carried through decode, refinement
and NMS as fixed ``[B, K, ...]`` tensors with a ``valid`` mask; ragged
per-image results appear only in :meth:`CPN.detach`. The top-K is a stable
descending sort, so ties keep the lower pixel index first, as ``lax.top_k``.

Training runs in fp32 with the module in train mode: batch statistics in
the norms, dropout in the heads, the foreground from the target labels and a
random selection priority drawn from the caller's ``torch.Generator``.
"""
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops import loss as L
from ..ops.commons import clip, downsample_labels, interpolate_nchw, process_scores
from ..ops.cpn import (batched_box_nms, fouriers2contours, order_weighting,
                       rel_location2abs_location, resolve_refinement_buckets, scale_contours,
                       scale_fourier)
from ..util.device import resolve_device
from ..util.init import torch_init_
from ..util.spans import count, host_syncs, recording, span
from . import fpn as fpn_lib
from . import manet as manet_lib
from . import resnet as resnet_lib
from . import unet as unet_lib
from .host_encoder import resolve_encoder
from .commons import Dropout2d, FusableReadOut, Fuse, ReadOut, ScaledTanh, fused_head_conv

__all__ = ['CPNCore', 'CPN', 'cpn_decode', 'cpn_compute_loss', 'DEFAULT_WEIGHTS',
           'apply_detection_offsets', 'local_refinement', 'get_cpn', 'models_by_name', 'CpnU22',
           'CpnSlimU22', 'CpnWideU22', 'CpnResUNet', 'CpnU17', 'CpnU12']


ENCODER_PREFIX = 'encoder.'


def _level_channels(backbone_channels, encoder_channels, key) -> int:
    """Channels of the map ``key``: decoder level ``'<k>'`` or encoder level
    ``'encoder.<k>'`` (a backbone's ``keep_features`` outputs)."""
    if isinstance(key, str) and key.startswith(ENCODER_PREFIX):
        if encoder_channels is None:
            raise ValueError(f'head feature {key!r}: the backbone gives no encoder levels')
        return encoder_channels[int(key[len(ENCODER_PREFIX):])]
    return backbone_channels[int(key)]


def _fuse_channels(backbone_channels, keys) -> int:
    """The ``Fuse`` output channels of a tuple of keys, as the JAX package's
    ``_resolve_channels`` gives them: the first key's, where an
    ``'encoder.<k>'`` key counts decoder level k's channels (the JAX CPN
    passes no encoder channels, so they default to the decoder's)."""
    key = keys[0]
    if isinstance(key, str) and key.startswith(ENCODER_PREFIX):
        key = key[len(ENCODER_PREFIX):]
    return backbone_channels[int(key)]


class CPNCore(nn.Module):
    """Backbone + dense CPN heads (score, location, Fourier, refinement, uncertainty).

    Takes NHWC input and returns NHWC dense maps: ``scores [B,h,w,C]``,
    ``locations [B,h,w,2]``, ``fourier [B,h,w,order*4]``, ``refinement
    [B,H,W,2*buckets]`` (input resolution) or None, ``uncertainty [B,h,w,4]``
    (sigmoid) or None. Convolutions run NCHW; with NHWC input they keep
    channels-last strides. A head reads one map, a decoder level (``'0'``,
    ``'1'``, ...) or an encoder level (``'encoder.0'``, ..., of
    ``encoder_channels``), or, for a tuple or list of keys, their fusion by a
    :class:`.commons.Fuse` named ``<head>_fuse`` (the refinement's
    ``refinement_fuse``), whose output has the first key's decoder level's
    channels, as in the JAX package. The contour heads fuse their first
    convolutions when they read the very same map (the JAX rule).
    """

    def __init__(self, backbone: nn.Module, backbone_channels, order: int, score_channels: int,
                 refinement: bool = True, refinement_margin: float = 3.,
                 uncertainty_head: bool = False, contour_features='1', location_features='1',
                 uncertainty_features='1', score_features='1', refinement_features='0',
                 contour_head_channels: Optional[int] = None, contour_head_stride: int = 1,
                 refinement_head_channels: Optional[int] = None, refinement_head_stride: int = 1,
                 refinement_interpolation: str = 'bilinear', refinement_buckets: int = 1,
                 refinement_full_res: bool = True, kernel_size_score: int = 7,
                 kernel_size_location: int = 7, kernel_size_fourier: int = 7,
                 kernel_size_refinement: int = 7, kernel_size_uncertainty: int = 7,
                 head_activation='relu', encoder_channels=None):
        super().__init__()
        if refinement_buckets < 1:
            raise ValueError(f'refinement_buckets={refinement_buckets}: at least 1')
        self.backbone = backbone
        self.encoder_channels = None if encoder_channels is None else tuple(encoder_channels)
        specs = [('score', score_features, score_channels, kernel_size_score, None),
                 ('location', location_features, 2, kernel_size_location, None),
                 ('fourier', contour_features, order * 4, kernel_size_fourier, None)]
        if uncertainty_head:
            specs.append(('uncertainty', uncertainty_features, 4, kernel_size_uncertainty,
                          'sigmoid'))
        self.specs = tuple(specs)
        for name, keys, out_c, ksize, final in self.specs:
            setattr(self, f'{name}_head', FusableReadOut(
                self._head_input(name, keys, backbone_channels), out_c, kernel_size=ksize,
                channels_mid=contour_head_channels, stride=contour_head_stride,
                activation=head_activation, final_activation=final))
        # The contour heads fuse into one conv when they read the same map with
        # the same geometry (always, at the defaults): one key here, or in
        # forward keys that name one tensor (a U-Net's deepest decoder level
        # is its deepest encoder level), as the JAX package decides.
        keys = [k for _, k, *_ in self.specs]
        self.same_geometry = len({s[3] for s in self.specs}) == 1 and \
            not any(isinstance(k, (tuple, list)) for k in keys)
        self.fusable = self.same_geometry and len(set(keys)) == 1
        self.refinement_features = refinement_features
        self.refinement_interpolation = refinement_interpolation
        self.refinement_full_res = refinement_full_res
        self.refinement_head = ReadOut(
            self._head_input('refinement', refinement_features, backbone_channels),
            2 * refinement_buckets, kernel_size=kernel_size_refinement,
            channels_mid=refinement_head_channels, stride=refinement_head_stride,
            activation=head_activation,
            final_activation=ScaledTanh(refinement_margin)) if refinement else None

    def _head_input(self, name: str, keys, backbone_channels) -> int:
        """The head's input channels; adds ``<name>_fuse`` for several keys."""
        if not isinstance(keys, (tuple, list)):
            return _level_channels(backbone_channels, self.encoder_channels, keys)
        channels = [_level_channels(backbone_channels, self.encoder_channels, k) for k in keys]
        out = _fuse_channels(backbone_channels, keys)
        setattr(self, f'{name}_fuse', Fuse(sum(channels), out))
        return out

    def _one_map(self, features) -> bool:
        """Whether the contour heads read one map with one geometry: one key,
        or keys that name the same tensor (the JAX package's rule)."""
        if self.fusable or not self.same_geometry:
            return self.fusable
        first = features[self.specs[0][1]]
        return all(features[k] is first for _, k, *_ in self.specs)

    def _features(self, features, name: str, keys) -> torch.Tensor:
        if isinstance(keys, (tuple, list)):
            return getattr(self, f'{name}_fuse')([features[k] for k in keys])
        return features[keys]

    def forward(self, inputs: torch.Tensor) -> Dict[str, Optional[torch.Tensor]]:
        x = inputs.permute(0, 3, 1, 2)
        features = self.backbone(x)
        heads = [getattr(self, f'{name}_head') for name, *_ in self.specs]
        if self._one_map(features):
            x0 = features[self.specs[0][1]]
            mid = fused_head_conv(x0, [h.conv0 for h in heads], heads[0].stride,
                                  heads[0].padding)
            outs, off = [], 0
            for h in heads:
                c = h.conv0.out_channels
                outs.append(h.tail(mid[:, off:off + c]))
                off += c
        else:
            outs = [h(self._features(features, name, keys))
                    for h, (name, keys, *_) in zip(heads, self.specs)]
        dense = {name: o.permute(0, 2, 3, 1) for (name, *_), o in zip(self.specs, outs)}
        refinement = None
        if self.refinement_head is not None:
            ref = self._features(features, 'refinement', self.refinement_features)
            if self.refinement_full_res:
                ref = interpolate_nchw(ref, x.shape[2:], self.refinement_interpolation)
            ref = self.refinement_head(ref)
            refinement = interpolate_nchw(ref, x.shape[2:],
                                          self.refinement_interpolation).permute(0, 2, 3, 1)
        return dict(scores=dense['score'], locations=dense['location'], refinement=refinement,
                    fourier=dense['fourier'], uncertainty=dense.get('uncertainty'))


def _gather_hw(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``[B, K, ...]`` of spatial maps ``[B, h, w, ...]`` by flat hw index ``[B, K]``."""
    b, h, w = x.shape[:3]
    rest = x.shape[3:]
    flat = x.reshape(b * h * w, -1)
    gi = idx + (torch.arange(b, device=idx.device) * (h * w))[:, None]
    return flat.index_select(0, gi.reshape(-1)).reshape(b, idx.shape[1], *rest)


def local_refinement(contours: torch.Tensor, refinement: torch.Tensor, num_loops: int,
                     num_buckets: int, original_size, sampling: Optional[torch.Tensor] = None):
    """Iterative offset-field refinement of ``[B, K, S, 2]`` (x, y) contours.

    Each loop rounds half to even, clamps to the image, truncates to integer
    pixels and adds the field's offset there; the field may be bf16, the
    positions stay fp32. The rounded positions carry no gradient (JAX's
    ``stop_gradient``); the offsets do. With ``num_buckets`` > 1 the field
    holds an (x, y) pair per bucket of the contour parameter ``sampling``
    (``[S]`` or ``[B, K, S]``), and a point's offset mixes the three buckets
    around its parameter with triangle weights
    (:func:`..ops.cpn.resolve_refinement_buckets`). Returns ``(refined,
    all_iterations)``.
    """
    h, w = original_size
    all_out = []
    det = contours
    taps = None
    if num_buckets != 1:
        if sampling is None:
            raise ValueError('refinement buckets need the contour sampling')
        shape = contours.shape[:3]
        taps = [(idx.expand(shape).long(), wt.expand(shape))
                for idx, wt in resolve_refinement_buckets(sampling, num_buckets)]
    for _ in range(num_loops):
        det = torch.round(det).detach()
        det = torch.stack([det[..., 0].clamp(0, w - 1), det[..., 1].clamp(0, h - 1)], -1)
        flat = det[..., 1].long() * w + det[..., 0].long()        # [B, K, S]
        b, k, s = flat.shape
        resp = _gather_hw(refinement, flat.reshape(b, k * s)).reshape(b, k, s, -1).to(det.dtype)
        if taps is None:
            responses = resp[..., :2]
        else:
            responses = None
            for idx, wt in taps:
                cur = torch.gather(resp, -1, torch.stack((idx * 2, idx * 2 + 1), -1))
                cur = cur * wt[..., None]
                responses = cur if responses is None else responses + cur
        det = det + responses
        all_out.append(det)
    return det, all_out


def cpn_decode(dense: Dict[str, torch.Tensor], input_size: Tuple[int, int], *, order: int,
               samples: int, score_channels: int, score_thresh, max_detections: int,
               refinement_iterations: int, refinement_buckets: int,
               certainty_thresh: Optional[float] = None,
               sampling: Optional[torch.Tensor] = None, labels: Optional[torch.Tensor] = None,
               priority: Optional[torch.Tensor] = None,
               scores_lower_bound=None, scores_upper_bound=None,
               offsets: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Dense head outputs → capacity-padded detections (no NMS).

    Args:
        certainty_thresh: With an uncertainty map, only pixels whose mean
            uncertainty lies below ``1 - certainty_thresh`` are foreground.
        sampling: Optional ``[B, S]`` contour sampling (training targets).
        labels: Optional ``[B, H', W']`` target labels: the foreground comes
            from them (max-pooled to the score map), not from the scores.
        priority: Optional ``[B, h, w]`` selection priority (training:
            random); the selection score by default.
        offsets: Optional ``[B, 2]`` float32 xy offsets (tiles of a mosaic):
            added after the clamping and the boxes, so clamping stays local.

    Returns ``contours [B,K,S,2], boxes [B,K,4], scores [B,K], classes [B,K],
    locations [B,K,2], fourier [B,K,order,4], contour_proposals,
    all_refined (tuple), box_uncertainties [B,K,4] (or None), valid [B,K], fg_index
    [B,K], fg_labels [B,K], fg_count [B], dense_scores, dense_labels``.
    """
    raw_scores = dense['scores']
    b_dim, h, w = raw_scores.shape[:3]
    scores, classes = process_scores(raw_scores, score_channels, score_thresh,
                                     scores_lower_bound, scores_upper_bound)
    fourier = dense['fourier'].reshape(b_dim, h, w, -1, 4)[..., :order, :]
    uncertainty = dense.get('uncertainty')
    labels = classes if labels is None else downsample_labels(labels.float(), (h, w))
    fg_mask = labels > 0
    if certainty_thresh is not None and uncertainty is not None:
        fg_mask = fg_mask & (uncertainty.mean(-1) < (1 - certainty_thresh))
    if score_channels in (1, 2):
        sel_score = scores[..., 0]
    else:
        sel_score = torch.gather(scores, -1, classes[..., None].long())[..., 0]
    if priority is None:
        priority = sel_score
    flat_priority = torch.where(fg_mask, priority, -torch.inf).reshape(b_dim, h * w)
    # top-K as a stable descending sort: ties (saturated sigmoids) keep the
    # lower index first, as lax.top_k; with fewer than K pixels, pad invalid
    k = min(max_detections, h * w)
    top_vals, top_idx = torch.sort(flat_priority, dim=1, descending=True, stable=True)
    top_vals, top_idx = top_vals[:, :k], top_idx[:, :k]
    if k < max_detections:
        pad = max_detections - k
        top_vals = torch.cat([top_vals, top_vals.new_full((b_dim, pad), -torch.inf)], -1)
        top_idx = torch.cat([top_idx, top_idx.new_zeros((b_dim, pad))], -1)
    valid = torch.isfinite(top_vals)
    fg_count = fg_mask.reshape(b_dim, -1).sum(-1)

    locations_abs = rel_location2abs_location(dense['locations'], channels_last=True)
    sel_fourier = _gather_hw(fourier, top_idx)                   # [B, K, order, 4]
    sel_locations = _gather_hw(locations_abs, top_idx)           # [B, K, 2]
    sel_classes = _gather_hw(classes[..., None], top_idx)[..., 0]
    sel_scores = _gather_hw(sel_score[..., None], top_idx)[..., 0]
    sel_labels = _gather_hw(labels[..., None].float(), top_idx)[..., 0]
    sel_uncertainty = None if uncertainty is None else _gather_hw(uncertainty, top_idx)
    if sampling is not None:
        sampling = sampling[:, None, :].expand(b_dim, max_detections, sampling.shape[-1])
    proposals, sampling = fouriers2contours(sel_fourier, sel_locations, samples=samples,
                                            sampling=sampling)

    actual_size = (h, w)
    proposals = scale_contours(actual_size, input_size, proposals)
    sel_fourier, sel_locations = scale_fourier(actual_size, input_size, sel_fourier,
                                               sel_locations)
    refinement = dense['refinement']
    if refinement is not None and refinement_iterations > 0:
        contours, all_refined = local_refinement(proposals, refinement, refinement_iterations,
                                                 refinement_buckets, input_size, sampling)
    else:
        contours, all_refined = proposals, [proposals]
    all_refined = [torch.stack([clip(c[..., 0], 0, input_size[1] - 1),
                                clip(c[..., 1], 0, input_size[0] - 1)], -1) for c in all_refined]
    contours = all_refined[-1]
    boxes = torch.cat((contours.amin(-2), contours.amax(-2)), -1)
    out = dict(contours=contours, boxes=boxes, scores=sel_scores, classes=sel_classes,
               locations=sel_locations, fourier=sel_fourier, contour_proposals=proposals,
               all_refined=tuple(all_refined), box_uncertainties=sel_uncertainty, valid=valid,
               fg_index=top_idx, fg_labels=sel_labels, fg_count=fg_count,
               dense_scores=raw_scores, dense_labels=labels)
    if offsets is not None:
        out = apply_detection_offsets(out, offsets)
    return out


def apply_detection_offsets(decoded: Dict[str, torch.Tensor], offsets: torch.Tensor) -> dict:
    """Shift every coordinate-valued output by ``offsets [B, 2]`` (xy) to global coordinates."""
    off = offsets.to(decoded['boxes'].dtype)[:, None]             # [B, 1, 2]
    out = dict(decoded)
    out['contours'] = decoded['contours'] + off[:, :, None]
    out['contour_proposals'] = decoded['contour_proposals'] + off[:, :, None]
    out['all_refined'] = tuple(c + off[:, :, None] for c in decoded['all_refined'])
    out['boxes'] = decoded['boxes'] + torch.cat([off, off], -1)
    out['locations'] = decoded['locations'] + off
    return out


# Loss weights of the reference CPN
DEFAULT_WEIGHTS = {
    'fourier': 1., 'location': 1., 'contour': 3., 'score_bg': 1., 'score_fg': 1.,
    'refinement': 1., 'boxes': .88, 'iou': 1., 'uncertainty': 1.,
}


def cpn_compute_loss(decoded: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor], *,
                     score_channels: int, order_weights=1., weights: Dict[str, float] = None,
                     uncertainty_factor: float = 7., uncertainty_head: bool = False,
                     iou_loss_enabled: bool = True, box_loss_enabled: bool = False,
                     refinement_enabled: bool = True):
    """CPN multi-objective loss on capacity-padded selections → ``(loss, losses)``.

    The score loss is dense over the fg/bg masks of the downsampled labels
    (equal to the mean over gathered pixels); the regression losses are
    masked means over the selected foreground pixels (``valid``), each
    against the target of the instance its pixel belongs to.
    """
    weights = DEFAULT_WEIGHTS if weights is None else weights
    raw_scores = decoded['dense_scores']
    labels = decoded['dense_labels']
    valid = decoded['valid']
    fg_mask = labels > 0
    bg_mask = labels == 0
    losses = {}

    class_targets = targets.get('classes')
    lbl_map = clip(labels.long() - 1, 0).reshape(labels.shape[0], -1)
    if score_channels == 1:
        logits = raw_scores[..., 0]
        if class_targets is not None:
            # fg targets are the per-instance classes even in the binary case
            fg_tgt = torch.gather(class_targets.float(), 1, lbl_map).reshape(labels.shape)
        else:
            fg_tgt = torch.ones_like(logits)
        losses['score'] = (
            weights['score_fg'] * L.bce_with_logits(logits, fg_tgt, mask=fg_mask)
            + weights['score_bg'] * L.bce_with_logits(logits, torch.zeros_like(logits),
                                                      mask=bg_mask))
    else:
        if class_targets is not None:
            cls_map = torch.gather(class_targets.long(), 1, lbl_map).reshape(labels.shape)
        else:
            cls_map = torch.ones_like(labels, dtype=torch.long)
        tgt = torch.where(fg_mask, cls_map, 0)
        losses['score'] = (
            weights['score_fg'] * L.cross_entropy(raw_scores, tgt, mask=fg_mask)
            + weights['score_bg'] * L.cross_entropy(raw_scores, torch.zeros_like(tgt),
                                                    mask=bg_mask))

    lbl_idx = clip(decoded['fg_labels'].long() - 1, 0)                  # [B, K]

    def take_target(t):
        if t is None:
            return None
        idx = lbl_idx.reshape(lbl_idx.shape + (1,) * (t.dim() - 2))
        return torch.gather(t, 1, idx.expand(lbl_idx.shape + t.shape[2:]))

    fourier_t = take_target(targets.get('fourier'))
    location_t = take_target(targets.get('locations'))
    contour_t = take_target(targets.get('sampled_contours'))
    hires_t = take_target(targets.get('hires_sampled_contours'))
    box_t = take_target(targets.get('boxes'))

    if fourier_t is not None:
        losses['fourier'] = weights['fourier'] * L.masked_mean(
            L._abs(decoded['fourier'] - fourier_t) * order_weights, valid)
    if location_t is not None:
        losses['location'] = weights['location'] * L.l1_loss(
            decoded['locations'], location_t, mask=valid)
    if contour_t is not None:
        losses['contour'] = weights['contour'] * L.l1_loss(
            decoded['contour_proposals'], contour_t, mask=valid)
        if box_t is None:
            box_t = torch.cat((contour_t.amin(-2), contour_t.amax(-2)), -1)
        if refinement_enabled:
            # with refinement off, all_refined holds only the clamped proposals
            cc_tar = hires_t if hires_t is not None else contour_t
            refinement_loss = 0.
            for ref_con in decoded['all_refined']:
                refinement_loss = refinement_loss + weights['refinement'] * L.l1_loss(
                    ref_con, cc_tar, mask=valid)
            losses['refinement'] = refinement_loss
    if box_t is not None:
        if iou_loss_enabled:
            losses['iou'] = weights['iou'] * L.iou_loss(decoded['boxes'], box_t, min_size=1.,
                                                        mask=valid)
        if box_loss_enabled:
            losses['boxes'] = weights['boxes'] * L.iou_loss(decoded['boxes'], box_t,
                                                            generalized=True, mask=valid)
        if uncertainty_head and decoded['box_uncertainties'] is not None:
            losses['uncertainty'] = weights['uncertainty'] * L.box_npll_loss(
                decoded['box_uncertainties'], decoded['boxes'].detach(), box_t,
                factor=uncertainty_factor, sigmoid=False, min_size=1., mask=valid)
    return sum(losses.values()), losses


_HEAD_DEFAULTS = dict(uncertainty_nms=False, contour_features='1', location_features='1',
                      score_features='1', uncertainty_features='1', refinement_features='0')


class CPN(nn.Module):
    """Contour Proposal Network (user-facing).

    Calling the model on a (batch of) image(s) returns per-image lists of
    ``contours, boxes, scores, classes, locations, fourier,
    contour_proposals, box_uncertainties`` plus ``fg_overflow``. In train
    mode, :meth:`forward_padded` with targets returns the loss as well (see
    :class:`..runtime.trainer.CPNTrainer`).

    Args:
        backbone: A backbone module exposing ``feature_channels``.
        max_detections: Detection capacity K per image.
        order_weights: True weighs the Fourier loss per order
            (:func:`..ops.cpn.order_weighting`), False not at all; or the
            ``[order, 1]`` weights themselves.
        certainty_thresh: Foreground needs a mean uncertainty below
            ``1 - certainty_thresh`` (with the uncertainty head).
        uncertainty_head: Adds a head of 4 sigmoid box-edge uncertainties,
            ``box_uncertainties`` per detection, and the ``uncertainty``
            loss term.
        uncertainty_nms: NMS ranks by ``scores * (1 - mean uncertainty)``.
        uncertainty_factor: Scale of the box-uncertainty loss.
        contour_features, location_features, score_features,
        uncertainty_features, refinement_features: Each head's decoder
            level (``'1'``) or encoder level (``'encoder.1'``), or a tuple or
            list of them to fuse (:class:`CPNCore`).
        compute_dtype: e.g. ``torch.bfloat16``: the parameters (fp32) and the
            input are cast for the backbone and heads, and decoding runs in
            fp32, except the refinement field, which stays in that dtype.
        max_imsize: :meth:`forward` sends a single image whose height or
            width exceeds it through :class:`..parallel.tiles.TiledInference`
            (``tile_size``, ``tile_stride``), in global coordinates; ``None``
            never tiles.
        device: Where the model lives; ``cuda`` by default (raises without a
            card), ``'cpu'`` on request.
    """

    def __init__(self, backbone: nn.Module, order: int = 5, nms_thresh: float = .2,
                 score_thresh: float = .9, samples: int = 32, classes: int = 2,
                 refinement: bool = True, refinement_iterations: int = 4,
                 refinement_margin: float = 3., refinement_buckets: int = 1,
                 certainty_thresh: Optional[float] = None, uncertainty_head: bool = False,
                 uncertainty_nms: bool = False, contour_features='1', location_features='1',
                 score_features='1', uncertainty_features='1',
                 refinement_features='0', contour_head_channels: int = None,
                 contour_head_stride: int = 1, refinement_head_channels: int = None,
                 refinement_head_stride: int = 1, refinement_interpolation: str = 'bilinear',
                 max_detections: int = 2048, compute_dtype: Optional[torch.dtype] = None,
                 max_imsize: Optional[int] = 2048, tile_size: int = 1024, tile_stride: int = 512,
                 order_weights=True, uncertainty_factor: float = 7., device=None):
        super().__init__()
        device = resolve_device(device)
        self.order = order
        self.nms_thresh = nms_thresh
        self.score_thresh = score_thresh
        self.certainty_thresh = certainty_thresh
        self.samples = samples
        self.score_channels = 1 if classes in (1, 2) else classes
        self.refinement = refinement
        self.refinement_iterations = refinement_iterations
        self.refinement_buckets = refinement_buckets
        self.max_detections = max_detections
        self.compute_dtype = compute_dtype
        self.max_imsize = max_imsize
        self.tile_size = tile_size
        self.tile_stride = tile_stride
        # what cpn_compute_loss reads
        self.weights = dict(DEFAULT_WEIGHTS)
        self.iou_loss_enabled = True
        self.box_loss_enabled = False
        self.uncertainty_head = uncertainty_head
        self.uncertainty_nms = uncertainty_nms
        self.uncertainty_factor = uncertainty_factor
        if order_weights is True:
            self.order_weights = order_weighting(order)
        elif order_weights is False:
            self.order_weights = 1.
        else:
            self.order_weights = torch.as_tensor(order_weights, dtype=torch.float32)
        self.core = CPNCore(
            backbone, tuple(backbone.feature_channels), order, self.score_channels,
            encoder_channels=getattr(backbone, 'encoder_channels', None),
            refinement=refinement, refinement_margin=refinement_margin,
            uncertainty_head=uncertainty_head, contour_features=contour_features,
            location_features=location_features, uncertainty_features=uncertainty_features,
            score_features=score_features, refinement_features=refinement_features,
            contour_head_channels=contour_head_channels, contour_head_stride=contour_head_stride,
            refinement_head_channels=refinement_head_channels,
            refinement_head_stride=refinement_head_stride,
            refinement_interpolation=refinement_interpolation,
            refinement_buckets=refinement_buckets)
        self.hparams = dict(order=order, nms_thresh=nms_thresh, score_thresh=score_thresh,
                            samples=samples, classes=classes, refinement=refinement,
                            refinement_iterations=refinement_iterations,
                            refinement_buckets=refinement_buckets,
                            uncertainty_head=uncertainty_head, max_detections=max_detections)
        # the head options a file must name to rebuild this model (the JAX
        # package's files leave them out, so they load with them as overrides)
        options = dict(uncertainty_nms=uncertainty_nms, contour_features=contour_features,
                       location_features=location_features, score_features=score_features,
                       uncertainty_features=uncertainty_features,
                       refinement_features=refinement_features)
        self.hparams.update({k: v for k, v in options.items() if v != _HEAD_DEFAULTS[k]})
        # dropout and stochastic depth (a Dropout2d): their generator is set per call
        self._dropouts = [m for m in self.core.modules() if isinstance(m, Dropout2d)]
        self.to(device)
        self.eval()

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward_padded(self, inputs: torch.Tensor, *, score_thresh=None, nms: bool = True,
                       offsets: Optional[torch.Tensor] = None, scores_lower_bound=None,
                       scores_upper_bound=None, max_detections: Optional[int] = None,
                       targets: Optional[Dict[str, torch.Tensor]] = None,
                       generator: Optional[torch.Generator] = None) -> dict:
        """Fixed-shape forward of NHWC float input: dense heads → padded detections.

        In eval mode it runs without autograd, in ``compute_dtype``, and ends
        with NMS. In train mode (``model.train()``) it runs in fp32 with
        autograd, batch statistics and dropout, and without NMS.

        Args:
            offsets: Optional ``[B, 2]`` xy offsets of the inputs in a mosaic
                (see :func:`cpn_decode`); with targets, added after the loss.
            max_detections: The capacity K of this call (the capacity retry
                of tiled inference); the model's by default.
            targets: Optional batch of :func:`..data.targets.collate_cpn_targets`
                tensors on the model's device (``labels``, ``fourier``,
                ``locations``, ``sampled_contours``, ``hires_sampled_contours``,
                ``sampling``, optional ``classes``): adds ``loss`` and
                ``losses`` to the output.
            generator: ``torch.Generator`` on the model's device for the
                random draws of training (the selection priority, which
                subsamples the foreground when it exceeds K, and dropout).

        Spans (:mod:`..util.spans`): ``cpn.forward`` (counts ``batch``, ``k``;
        on a card ``host_syncs``, the synchronising CUDA calls inside it, 0 in
        eval mode) over ``cpn.cast_weights`` (``tensors``; with ``compute_dtype``),
        ``cpn.core``, ``cpn.decode`` (``refine_iters``), ``cpn.loss`` and
        ``cpn.nms``.
        """
        train = self.training
        if train:
            for m in self._dropouts:
                m.generator = generator
        k = self.max_detections if max_detections is None else max_detections
        with torch.set_grad_enabled(train and torch.is_grad_enabled()), \
                span('cpn.forward', batch=inputs.shape[0], k=k), host_syncs(inputs.device):
            return self._forward_padded(inputs, score_thresh, nms, offsets, scores_lower_bound,
                                        scores_upper_bound, k, targets, generator)

    def _forward_padded(self, inputs, score_thresh, nms, offsets, scores_lower_bound,
                        scores_upper_bound, max_detections, targets, generator) -> dict:
        train = self.training
        score_thresh = self.score_thresh if score_thresh is None else score_thresh
        cdt = None if train else self.compute_dtype
        if cdt is None:
            with span('cpn.core'):
                dense = self.core(inputs)
        else:
            # a cast copy per call: one pass over the weights, far below a
            # forward's cost, and nothing to keep in step with the fp32 weights
            with span('cpn.cast_weights'):
                state = {k: t.to(cdt) if t.is_floating_point() else t
                         for k, t in self.core.state_dict().items()}
                if recording():
                    count('tensors', sum(t.is_floating_point() for t in state.values()))
            with span('cpn.core'):
                dense = torch.func.functional_call(self.core, state, (inputs.to(cdt),))
                dense = {k: (v if v is None or k == 'refinement' else v.float())
                         for k, v in dense.items()}
        labels = sampling = priority = None
        if targets is not None:
            labels, sampling = targets.get('labels'), targets.get('sampling')
            if train and generator is not None:
                # unbiased subsampling of the foreground when it exceeds K
                priority = torch.rand(dense['scores'].shape[:3], generator=generator,
                                      device=inputs.device)
        refine_iters = self.refinement_iterations if self.refinement else 0
        with span('cpn.decode', refine_iters=refine_iters):
            decoded = cpn_decode(
                dense, tuple(inputs.shape[1:3]), order=self.order, samples=self.samples,
                score_channels=self.score_channels, score_thresh=score_thresh,
                max_detections=max_detections, refinement_iterations=refine_iters,
                refinement_buckets=self.refinement_buckets,
                certainty_thresh=self.certainty_thresh, sampling=sampling, labels=labels,
                priority=priority, scores_lower_bound=scores_lower_bound,
                scores_upper_bound=scores_upper_bound,
                offsets=None if targets is not None else offsets)
        if targets is not None:
            ow = self.order_weights
            with span('cpn.loss'):
                decoded['loss'], decoded['losses'] = cpn_compute_loss(
                    decoded, targets, score_channels=self.score_channels,
                    order_weights=ow.to(inputs.device) if torch.is_tensor(ow) else ow,
                    weights=self.weights, uncertainty_factor=self.uncertainty_factor,
                    uncertainty_head=self.uncertainty_head,
                    iou_loss_enabled=self.iou_loss_enabled,
                    box_loss_enabled=self.box_loss_enabled,
                    refinement_enabled=bool(self.refinement) and self.refinement_iterations > 0)
            if offsets is not None:
                decoded = apply_detection_offsets(decoded, offsets)
        if nms and not train:
            with span('cpn.nms'):
                weights = decoded['scores']
                if self.uncertainty_nms and decoded['box_uncertainties'] is not None:
                    weights = weights * (1. - decoded['box_uncertainties'].mean(-1))
                keep = batched_box_nms(decoded['boxes'], weights, decoded['valid'],
                                       self.nms_thresh)
                decoded['valid'] = decoded['valid'] & keep
        return decoded

    def prepare_inputs(self, inputs) -> torch.Tensor:
        """numpy or tensor HWC, NHWC or NCHW images (uint8 → /255) → float32 NHWC on the model's device."""
        is_tensor = isinstance(inputs, torch.Tensor)
        x = inputs if is_tensor else np.asarray(inputs)
        if x.ndim == 2:
            x = x[..., None]
        if x.ndim == 3:
            x = x[None]
        in_c = self.hparams.get('in_channels')
        if in_c is not None and x.shape[1] != x.shape[-1]:
            nchw = x.shape[1] == in_c and x.shape[-1] != in_c
        else:
            nchw = x.shape[1] <= 8 < x.shape[-1]
        if nchw:
            x = x.permute(0, 2, 3, 1) if is_tensor else np.moveaxis(x, 1, -1)
        if not is_tensor:
            if np.issubdtype(x.dtype, np.floating) and x.size and float(x.max()) > 2.:
                warnings.warn(f'prepare_inputs: float input with max {float(x.max()):.3g} '
                              f'exceeds the expected [0, 1] range; values are clamped by '
                              f'Normalize. Scale inputs to [0, 1] (or pass uint8).')
            x = torch.from_numpy(np.ascontiguousarray(x))
        if x.dtype == torch.uint8:
            x = x.float() / 255.
        return x.to(device=self.device, dtype=torch.float32)

    def forward(self, inputs, targets: Optional[dict] = None, nms: bool = True,
                score_thresh=None, scores_lower_bound=None, scores_upper_bound=None) -> dict:
        """Per-image ragged results for a (batch of) image(s).

        With ``targets`` (the batch of
        :func:`..data.targets.collate_cpn_targets`, numpy or tensors) the
        result holds ``loss`` and ``losses`` as well, as the reference's
        ``CPN.forward`` does.

        A single image larger than ``max_imsize`` goes through tiled inference
        (``nms`` and the score bounds do not apply there): the results are in
        global coordinates, each key a list of one array as from
        :meth:`detach`, beside ``num_tiles``, ``num_valid`` and
        ``fg_overflow`` (one flag: any overflow of the tiled run).
        """
        x = self.prepare_inputs(inputs)
        if self.max_imsize is not None and max(x.shape[1:3]) > self.max_imsize:
            from ..parallel.tiles import TiledInference
            if x.shape[0] != 1:
                raise ValueError(f'auto-tiled forward takes a single image, got {x.shape[0]}')
            if targets is not None:
                raise ValueError('auto-tiled forward is inference only: it takes no targets')
            tiled = TiledInference(self, tile_size=self.tile_size, stride=self.tile_stride)
            res = tiled(x[0].cpu().numpy(), score_thresh=score_thresh)
            out = {k: ([v] if isinstance(v, np.ndarray) else v) for k, v in res.items()}
            out['fg_overflow'] = out.pop('overflow')
            out.setdefault('contour_proposals', None)
            out.setdefault('box_uncertainties', None)
            return out
        if targets is not None:
            targets = {k: torch.as_tensor(v).to(x.device) for k, v in targets.items()}
        out = self.forward_padded(x, score_thresh=score_thresh, nms=nms, targets=targets,
                                  scores_lower_bound=scores_lower_bound,
                                  scores_upper_bound=scores_upper_bound)
        return self.detach(out)

    @staticmethod
    def detach(out: Dict[str, torch.Tensor]) -> Dict[str, list]:
        """Padded tensors → per-image ragged numpy lists (host boundary)."""
        valid = out['valid'].cpu().numpy()
        result = {}
        for k in ('contours', 'boxes', 'scores', 'classes', 'locations', 'fourier',
                  'contour_proposals', 'box_uncertainties'):
            v = out.get(k)
            if v is None:
                result[k] = None
                continue
            v = v.cpu().numpy()
            result[k] = [v[i][valid[i]] for i in range(v.shape[0])]
        if 'loss' in out:
            result['loss'] = out['loss'].detach().cpu().numpy()
            result['losses'] = {k: (None if v is None else v.detach().cpu().numpy())
                                for k, v in out['losses'].items()}
        capacity = valid.shape[1]
        result['fg_overflow'] = [bool(c > capacity) for c in out['fg_count'].cpu().numpy()]
        return result


models_by_name = {}


def register_model(fn):
    models_by_name[fn.__name__] = fn
    return fn


def _make_cpn(backbone_fn, in_channels, backbone_kwargs=None, device=None, name=None,
              torch_init: bool = True, seed: int = 0, **kwargs):
    """Build the CPN ``name``; ``torch_init`` re-draws its convolutions to the
    reference's init (:func:`..util.init.torch_init_`) from ``seed``, as the
    JAX package's ``CPN.init`` does by default; then a ``pretrained`` spec of
    ``backbone_kwargs`` loads the encoder's ImageNet weights."""
    device = resolve_device(device)   # fail before building on a card-less host
    backbone_kwargs = dict(backbone_kwargs or {})
    _check_2d(name, backbone_kwargs)
    pretrained = backbone_kwargs.pop('pretrained', False)
    backbone = backbone_fn(in_channels, 0, backbone_kwargs=dict(backbone_kwargs))
    return _finish_cpn(backbone, name, device, in_channels, backbone_kwargs, torch_init, seed,
                       pretrained, **kwargs)


def _check_2d(name, backbone_kwargs):
    """The CPN decode is 2-D in both packages: a backbone of another rank is refused here."""
    nd = backbone_kwargs.get('nd', 2)
    if nd != 2:
        raise ValueError(f'{name or "CPN"}: backbone_kwargs nd={nd}; the CPN decodes 2-D '
                         f'contours, so only its backbone blocks run 3-D (build them alone, '
                         f"e.g. models.U22(1, 2, nd=3))")


def _finish_cpn(backbone, name, device, in_channels, backbone_kwargs, torch_init, seed,
                pretrained, **kwargs):
    model = CPN(backbone=backbone, device=device, **kwargs)
    model.hparams.update(in_channels=in_channels, backbone_kwargs=backbone_kwargs)
    if name is not None:
        model.hparams['model'] = name
    if torch_init:
        torch_init_(model, seed=seed)
    if pretrained:
        from ..util.pretrained import apply_pretrained_
        apply_pretrained_(model, pretrained)
    return model


@register_model
def CpnU22(in_channels: int, order: int = 5, nms_thresh: float = .2, score_thresh: float = .9,
           samples: int = 32, classes: int = 2, refinement: bool = True,
           refinement_iterations: int = 4, refinement_margin: float = 3.,
           refinement_buckets: int = 1, backbone_kwargs: dict = None, **kwargs):
    """CPN with a U22 backbone."""
    return _make_cpn(unet_lib.U22, in_channels, backbone_kwargs, name='CpnU22', order=order,
                     nms_thresh=nms_thresh, score_thresh=score_thresh, samples=samples,
                     classes=classes, refinement=refinement,
                     refinement_iterations=refinement_iterations,
                     refinement_margin=refinement_margin, refinement_buckets=refinement_buckets,
                     **kwargs)


def _register_unet_cpns():
    """``CpnSlimU22``, ``CpnWideU22``, ``CpnResUNet``, ``CpnU17``, ``CpnU12``:
    the JAX package's short signatures (every CPN option through ``kwargs``)."""
    docs = {'SlimU22': 'a SlimU22 backbone (U22 at base 32)',
            'WideU22': 'a WideU22 backbone (U22 at base 96)',
            'ResUNet': 'a residual U-Net backbone', 'U17': 'a U17 backbone (4 resolutions)',
            'U12': "a U12 backbone (U22's modules at depth 3)"}

    def make(cpn_name, backbone_fn, doc):
        def ctor(in_channels: int, backbone_kwargs: dict = None, **kwargs):
            return _make_cpn(backbone_fn, in_channels, backbone_kwargs, name=cpn_name, **kwargs)
        ctor.__name__ = ctor.__qualname__ = cpn_name
        ctor.__doc__ = f'CPN with {doc}.'
        return ctor

    for unet_name, doc in docs.items():
        name = f'Cpn{unet_name}'
        models_by_name[name] = globals()[name] = make(name, getattr(unet_lib, unet_name), doc)


_register_unet_cpns()


def _manet_backbone(resnet_ctor):
    """MaNet over a ResNet encoder, at the ResNet's default ``fused_initial=True``."""
    def ctor(in_channels, out_channels=0, backbone_kwargs=None, **kwargs):
        return manet_lib.MaNet(body=resnet_ctor(in_channels, **(backbone_kwargs or {})),
                               **kwargs)
    return ctor


def _register_host_cpns():
    """``CpnTimmUNet``, ``CpnSmpUNet``, ``CpnTimmMaNet``, ``CpnSmpMaNet`` and
    ``CpnMiTB5MaNet`` (smp's ``mit_b5``): a native encoder for a name of
    ``host_encoder.NATIVE_ENCODER_NAMES``, else timm's or smp's (which
    raises ``ImportError`` naming the package where it is missing)."""
    def make(cpn_name, adapter, decoder):
        def ctor(in_channels: int, model_name: str, backbone_kwargs: dict = None, device=None,
                 torch_init: bool = True, seed: int = 0, **kwargs):
            device = resolve_device(device)
            bk = dict(backbone_kwargs or {})
            _check_2d(cpn_name, bk)
            pretrained = bk.pop('pretrained', False)
            body, native = resolve_encoder(adapter, model_name, in_channels, pretrained, bk)
            if decoder == 'UNet':
                backbone = unet_lib.UNet(body=body, in_channels_list=list(body.out_channels),
                                         in_strides_list=list(body.out_strides))
            else:
                backbone = manet_lib.MaNet(body=body)
            model = _finish_cpn(backbone, cpn_name, device, in_channels, bk, torch_init, seed,
                                pretrained if native else False, **kwargs)
            model.hparams['model_name'] = model_name
            return model
        ctor.__name__ = ctor.__qualname__ = cpn_name
        ctor.__doc__ = f'CPN with a {decoder} over a {adapter} encoder named ``model_name``.'
        return ctor

    for adapter in ('timm', 'smp'):
        for decoder in ('UNet', 'MaNet'):
            name = f'Cpn{adapter.capitalize()}{decoder}'
            models_by_name[name] = globals()[name] = make(name, adapter, decoder)
            __all__.append(name)
    smp_manet = models_by_name['CpnSmpMaNet']

    def CpnMiTB5MaNet(in_channels: int, backbone_kwargs: dict = None, **kwargs):
        """CPN with a MaNet over smp's MiT-B5 encoder (needs smp)."""
        kwargs.pop('model_name', None)   # the encoder is fixed; saved hparams carry it
        model = smp_manet(in_channels, model_name='mit_b5', backbone_kwargs=backbone_kwargs,
                          **kwargs)
        model.hparams['model'] = 'CpnMiTB5MaNet'
        return model

    models_by_name['CpnMiTB5MaNet'] = globals()['CpnMiTB5MaNet'] = CpnMiTB5MaNet
    __all__.append('CpnMiTB5MaNet')


_register_host_cpns()


def _register_backbone_cpns():
    """``Cpn<Encoder>{UNet,FPN,MaNet}``: CPNs over the encoder UNets, the FPNs and the MaNets."""
    def make(cpn_name, backbone_fn):
        def ctor(in_channels: int, order: int = 5, nms_thresh: float = .2,
                 score_thresh: float = .9, samples: int = 32, classes: int = 2,
                 refinement: bool = True, refinement_iterations: int = 4,
                 refinement_margin: float = 3., refinement_buckets: int = 1,
                 backbone_kwargs: dict = None, **kwargs):
            return _make_cpn(backbone_fn, in_channels, backbone_kwargs, name=cpn_name,
                             order=order, nms_thresh=nms_thresh, score_thresh=score_thresh,
                             samples=samples, classes=classes, refinement=refinement,
                             refinement_iterations=refinement_iterations,
                             refinement_margin=refinement_margin,
                             refinement_buckets=refinement_buckets, **kwargs)
        ctor.__name__ = ctor.__qualname__ = cpn_name
        ctor.__doc__ = f'CPN with a {cpn_name[3:]} backbone.'
        return ctor

    specs = {}
    for name in ('ResNet18', 'ResNet34', 'ResNet50', 'ResNet101', 'ResNet152', 'ResNeXt50',
                 'ResNeXt101', 'ResNeXt152', 'WideResNet50', 'WideResNet101'):
        specs[f'Cpn{name}UNet'] = getattr(unet_lib, f'{name}UNet')
        specs[f'Cpn{name}FPN'] = getattr(fpn_lib, f'{name}FPN')
    for name in ('ConvNeXtTiny', 'ConvNeXtSmall', 'ConvNeXtBase', 'ConvNeXtLarge',
                 'ConvNeXtV2Tiny', 'ConvNeXtV2Base', 'DenseNet121', 'DenseNet161',
                 'DenseNet169', 'DenseNet201', 'MobileNetV3Large', 'MobileNetV3Small'):
        specs[f'Cpn{name}UNet'] = getattr(unet_lib, f'{name}UNet')
    for name in ('MobileNetV3Large', 'MobileNetV3Small'):
        specs[f'Cpn{name}FPN'] = getattr(fpn_lib, f'{name}FPN')
    specs['CpnResNet50MaNet'] = _manet_backbone(resnet_lib.ResNet50)
    specs['CpnResNet18MaNet'] = _manet_backbone(resnet_lib.ResNet18)
    for cpn_name, backbone_fn in specs.items():
        models_by_name[cpn_name] = globals()[cpn_name] = make(cpn_name, backbone_fn)
        __all__.append(cpn_name)


_register_backbone_cpns()


def get_cpn(name: str):
    """Look up a CPN model constructor by name."""
    if name not in models_by_name:
        raise KeyError(f'Unknown CPN model: {name}. Available: {sorted(models_by_name)}')
    return models_by_name[name]
