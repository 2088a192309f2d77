"""Plain PyTorch reference of a Contour Proposal Network (CPN), for the benchmark's checks.

It follows the published CPN of celldetection v0.4.9 (``celldetection/models/
cpn.py``: ``CPNCore``, ``CPN.forward``; ``celldetection/ops/cpn.py``:
``fouriers2contours``, ``rel_location2abs_location``, ``local_refinement``;
``torchvision.ops.boxes``' greedy NMS) and imports torch alone: nothing of the
program under test. Parameters are a dict of tensors under the published
module names (``core.backbone.body.0.0.weight``, ...), so that the benchmark
can hand the very same seeded weights to the program and to this reference.

A :class:`Precision` says how the convolutions run: ``fp32`` (the reference:
float32 with TF32 off, see :func:`exact_fp32`), ``bf16`` (weights and
activations in bfloat16) or ``fp8`` (weights and activations rounded to
float8 e4m3 with one scale per tensor, products summed in float32, the
activations kept in bfloat16): the two lower ones are the controls.
"""
import contextlib
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
FP8_MAX = 448.0          # largest finite float8 e4m3fn value


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for cuDNN convolutions and matmuls inside the block, restored after."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _fp8(t: torch.Tensor):
    """``t`` rounded to float8 e4m3 under one scale (its largest magnitude to 448), as float32."""
    t = t.float()
    scale = (t.abs().amax() / FP8_MAX).clamp(min=1e-30)
    return (t / scale).to(torch.float8_e4m3fn).float(), scale


class Precision:
    """How the reference runs its backbone and heads: 'fp32', 'bf16' or 'fp8'."""

    def __init__(self, name: str):
        if name not in ('fp32', 'bf16', 'fp8'):
            raise ValueError(f'unknown precision {name!r}')
        self.name = name
        self.dtype = torch.float32 if name == 'fp32' else torch.bfloat16

    def conv(self, x, w, b=None, stride=1, padding=0, groups=1):
        if self.name == 'fp8':
            xq, sx = _fp8(x)
            wq, sw = _fp8(w)
            y = F.conv2d(xq, wq, None, stride, padding, 1, groups) * (sx * sw)
            if b is not None:
                y = y + b.float().reshape(1, -1, 1, 1)
            return y.to(self.dtype)
        return F.conv2d(x, w.to(self.dtype), None if b is None else b.to(self.dtype),
                        stride, padding, 1, groups)

    def bn(self, x, p, key):
        args = [p[f'{key}.{k}'].to(self.dtype) for k in ('running_mean', 'running_var',
                                                          'weight', 'bias')]
        return F.batch_norm(x, *args, training=False, momentum=0., eps=BN_EPS)


def conv(x, p, key, prec, stride=1, groups=1):
    """The convolution ``key`` of ``p`` ('same' padding for odd kernels, as the CPN's)."""
    w = p[f'{key}.weight']
    return prec.conv(x, w, p.get(f'{key}.bias'), stride, w.shape[-1] // 2, groups)


def two_conv(x, p, key, prec):
    """U-Net block: (3x3 conv, batch norm, ReLU) twice; children 0, 1 and 3, 4."""
    x = F.relu(prec.bn(conv(x, p, f'{key}.0', prec), p, f'{key}.1'))
    return F.relu(prec.bn(conv(x, p, f'{key}.3', prec), p, f'{key}.4'))


def unet_decoder(feats: List[torch.Tensor], p, prec, in_list, bridges, prefix):
    """The U-Net decoder, top-down: the inner 1x1 conv (where it narrows), a
    nearest 2x upsample, the concatenation with the encoder level, a block.
    Bridge levels (``in_list[i] == 0``) have no encoder level. Returns the
    decoder levels, finest first."""
    last = feats[-1]
    results = [last]
    for i in range(len(in_list) - 2, -1, -1):
        lateral = feats[i - bridges] if in_list[i] > 0 else None
        top = last
        if f'{prefix}.inner_blocks.{i}.weight' in p:
            top = conv(top, p, f'{prefix}.inner_blocks.{i}', prec)
        size = lateral.shape[2:] if lateral is not None else tuple(2 * s for s in top.shape[2:])
        top = F.interpolate(top, size=size, mode='nearest')
        x = top if lateral is None else torch.cat([lateral, top], 1)
        last = two_conv(x, p, f'{prefix}.layer_blocks.{i}', prec)
        results.insert(0, last)
    return results


def readout(x, p, key, prec):
    """CPN head: conv (7x7), batch norm, ReLU, (dropout: none at inference), 1x1 conv."""
    y = F.relu(prec.bn(conv(x, p, f'{key}.block.0', prec), p, f'{key}.block.1'))
    return conv(y, p, f'{key}.block.4', prec)


def heads(levels: Dict[str, torch.Tensor], p, prec, margin: float) -> Dict[str, torch.Tensor]:
    """Dense CPN outputs, NHWC: score logits, relative locations and Fourier
    descriptors from level '1', the refinement field ``margin * tanh`` from
    level '0' at input resolution. All float32 but the refinement field,
    which stays in the compute type, as the CPN's inference keeps it."""
    f1 = levels['1']
    out = {name: readout(f1, p, f'core.{name}_head', prec).float().permute(0, 2, 3, 1)
           for name in ('score', 'location', 'fourier')}
    ref = torch.tanh(readout(levels['0'], p, 'core.refinement_head', prec)) * margin
    return dict(scores=out['score'], locations=out['location'], fourier=out['fourier'],
                refinement=ref.permute(0, 2, 3, 1))


def normalize(x):
    """The CPN's input normalisation at mean 0, std 1: a clamp to [0, 1]."""
    return x.clamp(0., 1.)


# ----------------------------------------------------------------- decode


def abs_locations(rel: torch.Tensor) -> torch.Tensor:
    """``[B, h, w, 2]`` relative (x, y) locations plus the pixel grid."""
    h, w = rel.shape[1:3]
    gy, gx = torch.meshgrid(torch.arange(h, dtype=rel.dtype, device=rel.device),
                            torch.arange(w, dtype=rel.dtype, device=rel.device), indexing='ij')
    return rel + torch.stack((gx, gy), -1)


def contours_from_fourier(fourier: torch.Tensor, locations: torch.Tensor, samples: int):
    """Inverse elliptic Fourier transform: ``[..., order, 4]`` (a, b, c, d) and
    ``[..., 2]`` centres to ``[..., samples, 2]`` contours sampled at
    ``t = i / (samples - 1)``: ``x = sum_k a_k cos(2 pi k t) + b_k sin(2 pi k t)``,
    ``y`` the same with ``c, d``."""
    order = fourier.shape[-2]
    t = torch.linspace(0, 1, samples, dtype=torch.float64, device=fourier.device)
    k = torch.arange(1, order + 1, dtype=torch.float64, device=fourier.device)
    ang = 2 * np.pi * k[:, None] * t[None, :]                     # [order, samples]
    cos, sin = torch.cos(ang).to(fourier.dtype), torch.sin(ang).to(fourier.dtype)
    x = torch.einsum('...k,ks->...s', fourier[..., 0], cos) + \
        torch.einsum('...k,ks->...s', fourier[..., 1], sin)
    y = torch.einsum('...k,ks->...s', fourier[..., 2], cos) + \
        torch.einsum('...k,ks->...s', fourier[..., 3], sin)
    return torch.stack((x, y), -1) + locations[..., None, :]


def gather_hw(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``[B, K, ...]`` of ``[B, h, w, ...]`` maps at flat pixel indices ``[B, K]``."""
    b, h, w = x.shape[:3]
    flat = x.reshape(b, h * w, -1)
    out = torch.gather(flat, 1, idx[..., None].expand(-1, -1, flat.shape[-1]))
    return out.reshape(idx.shape + x.shape[3:])


def refine_step(det: torch.Tensor, field: torch.Tensor, size):
    """One refinement step of ``[B, K, S, 2]`` (x, y) points over the field
    ``[B, H, W, 2]``: round half to even, clamp to the image, add the field's
    offset at that pixel."""
    h, w = size
    r = torch.round(det)
    r = torch.stack((r[..., 0].clamp(0, w - 1), r[..., 1].clamp(0, h - 1)), -1)
    b, k, s = r.shape[:3]
    flat = (r[..., 1].long() * w + r[..., 0].long()).reshape(b, k * s)
    off = gather_hw(field, flat).reshape(b, k, s, 2).float()
    return r + off


def clip_xy(c: torch.Tensor, size) -> torch.Tensor:
    h, w = size
    return torch.stack((c[..., 0].clamp(0, w - 1), c[..., 1].clamp(0, h - 1)), -1)


def decode(dense: Dict[str, torch.Tensor], size, cfg: dict, thresh: float, capacity: int):
    """The CPN's decode of dense maps into ``capacity`` proposals per image:
    the foreground is ``sigmoid(score) > thresh``; the proposals are its
    ``capacity`` best pixels by score (a stable sort: ties keep the lower
    index), padded with invalid rows; contours from the Fourier head,
    scaled from the score map to the input, refined ``refinement_iterations``
    times, clipped to the image; boxes are the contours' extents."""
    logits = dense['scores'][..., 0]
    b, h, w = logits.shape
    scores = torch.sigmoid(logits)
    fg = scores > thresh
    prio = torch.where(fg, scores, -torch.inf).reshape(b, h * w)
    vals, idx = torch.sort(prio, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :capacity], idx[:, :capacity]
    order = cfg['order']
    fourier = gather_hw(dense['fourier'].reshape(b, h, w, -1, 4)[..., :order, :], idx)
    locations = gather_hw(abs_locations(dense['locations']), idx)
    scale = torch.tensor([size[1] / w, size[0] / h], dtype=torch.float32, device=logits.device)
    fourier = fourier * scale.repeat_interleave(2)
    locations = locations * scale
    proposals = contours_from_fourier(fourier, locations, cfg['samples'])
    steps, det = [], proposals
    for _ in range(cfg['refinement_iterations']):
        det = refine_step(det, dense['refinement'], size)
        steps.append(clip_xy(det, size))
    contours = steps[-1] if steps else clip_xy(proposals, size)
    return dict(fg_index=idx, valid=torch.isfinite(vals),
                scores=gather_hw(scores[..., None], idx)[..., 0],
                locations=locations, fourier=fourier, contour_proposals=proposals,
                all_refined=steps, contours=contours,
                boxes=torch.cat((contours.amin(-2), contours.amax(-2)), -1),
                fg_count=fg.reshape(b, -1).sum(1), dense_scores=dense['scores'])


# ----------------------------------------------------------------- greedy NMS


def box_area(b):
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def suppresses(b1: torch.Tensor, b2: torch.Tensor, thresh: float) -> torch.Tensor:
    """``[n, m]``: box i of ``b1`` suppresses box j of ``b2``, ``IoU > thresh``
    tested as ``inter > thresh * union`` with ``union = (area1 + area2) - inter``
    in float32, one operation at a time (no fused multiply-add)."""
    a1, a2 = box_area(b1), box_area(b2)
    lt = torch.maximum(b1[:, None, :2], b2[None, :, :2])
    rb = torch.minimum(b1[:, None, 2:], b2[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = (a1[:, None] + a2[None, :]) - inter
    return torch.where(union > 0, inter, 0.) > thresh * union


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, thresh: float,
               block: int = 2048) -> torch.Tensor:
    """Exact greedy NMS of one image: boxes in descending score order (stable),
    each kept iff no kept box before it suppresses it. Returns the keep mask
    ``[N]`` in the input order. Works in blocks of ``block`` rows: a block is
    first tested against every box kept before it, then resolved in order."""
    n = valid.shape[0]
    order = torch.sort(torch.where(valid, scores, -torch.inf), descending=True,
                       stable=True).indices
    m = int(valid.sum())
    order = order[:m]
    b = boxes[order].float()
    keep = np.zeros(m, bool)
    kept = b.new_zeros((0, 4))
    for s in range(0, m, block):
        rows = b[s:s + block]
        alive = torch.ones(rows.shape[0], dtype=torch.bool, device=b.device)
        for c in range(0, kept.shape[0], 8192):
            alive &= ~suppresses(kept[c:c + 8192], rows, thresh).any(0)
        sup = suppresses(rows, rows, thresh).cpu().numpy()
        alive = alive.cpu().numpy()
        for j in range(rows.shape[0]):
            if alive[j]:
                alive[j + 1:] &= ~sup[j, j + 1:]
        keep[s:s + rows.shape[0]] = alive
        kept = torch.cat([kept, rows[torch.from_numpy(alive).to(b.device)]])
    out = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    out[order[torch.from_numpy(keep).to(boxes.device)]] = True
    return out


# ----------------------------------------------------------------- shapes


def bn_shapes(out: dict, key: str, c: int):
    for k in ('weight', 'bias', 'running_mean', 'running_var'):
        out[f'{key}.{k}'] = (c,)


def conv_shapes(out: dict, key: str, cin: int, cout: int, k: int, bias: bool = True,
                groups: int = 1):
    out[f'{key}.weight'] = (cout, cin // groups, k, k)
    if bias:
        out[f'{key}.bias'] = (cout,)


def two_conv_shapes(out: dict, key: str, cin: int, cout: int, bias: bool = True):
    conv_shapes(out, f'{key}.0', cin, cout, 3, bias)
    bn_shapes(out, f'{key}.1', cout)
    conv_shapes(out, f'{key}.3', cout, cout, 3, bias)
    bn_shapes(out, f'{key}.4', cout)


def decoder_shapes(out: dict, prefix: str, in_list, out_list):
    """The U-Net decoder's parameters (see :func:`unet_decoder`)."""
    depth = len(in_list) - 1
    for i in range(depth - 1, -1, -1):
        inc = out_list[i + 1] if i + 1 < depth else in_list[i + 1]
        top = inc
        if out_list[i] < inc:
            conv_shapes(out, f'{prefix}.inner_blocks.{i}', inc, out_list[i], 1)
            top = out_list[i]
        two_conv_shapes(out, f'{prefix}.layer_blocks.{i}', in_list[i] + top, out_list[i],
                        bias=in_list[i] > 0)


def head_shapes(out: dict, channels, cfg: dict):
    """The score, location and Fourier heads on level '1', the refinement head on level '0'."""
    k = cfg['head_kernel']
    for name, c_out in (('score', 1), ('location', 2), ('fourier', 4 * cfg['order'])):
        c = channels[1]
        conv_shapes(out, f'core.{name}_head.block.0', c, c, k)
        bn_shapes(out, f'core.{name}_head.block.1', c)
        conv_shapes(out, f'core.{name}_head.block.4', c, c_out, 1)
    c = channels[0]
    conv_shapes(out, 'core.refinement_head.block.0', c, c, k)
    bn_shapes(out, 'core.refinement_head.block.1', c)
    conv_shapes(out, 'core.refinement_head.block.4', c, 2, 1)


def dense_forward(model, p: dict, x: torch.Tensor, cfg: dict, prec: Precision):
    """NHWC float images in [0, 1] to the dense CPN outputs of :func:`heads`.
    ``model`` is a configuration's reference module (its ``levels``)."""
    x = normalize(x.permute(0, 3, 1, 2).to(prec.dtype))
    return heads(model.levels(p, x, cfg, prec), p, prec, cfg['refinement_margin'])


def infer_padded(model, p, x, cfg, prec, thresh, nms_thresh):
    """Decoded and NMS-filtered ``[B, K]`` detections of NHWC images, as a CPN's
    padded inference gives them (``valid`` is the keep mask after NMS)."""
    with exact_fp32():
        dense = dense_forward(model, p, x, cfg, prec)
        dec = decode(dense, tuple(x.shape[1:3]), cfg, thresh, cfg['max_detections'])
    keep = torch.stack([greedy_nms(dec['boxes'][i], dec['scores'][i], dec['valid'][i], nms_thresh)
                        for i in range(x.shape[0])])
    dec['valid'] = dec['valid'] & keep
    return dec
