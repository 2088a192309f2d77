#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``celldetection_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvidia-smi`` and ``nvcc`` (on ``PATH``, under
``$CUDA_HOME`` or ``/usr/local/cuda``). Without a card, or without the
package beside it, it exits non-zero before it prints any result.

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit, the torch and CUDA versions;
  2. build every kernel of ``celldetection_tpu_torch/csrc`` for sm_90a, one
     nvcc per source, all at once, and print ptxas's registers, shared memory
     and spills;
  3. every NMS kernel against its plain PyTorch version on the card, bit for
     bit, and the whole sweep against ``_nms_sweep``: batched, large, ragged,
     tiny, all-invalid and knife-edge inputs, and at stitch scale (56 images
     of 16,384 boxes, one image of 262,144, and one of 262,145, the smallest
     that takes the large layout). At the main path's and the stitch's
     shapes it times the sweep per call (CUDA events) and each kernel on the
     device (CUDA events around each launch), beside the bound, the plain version, the launches
     per call, the peak scratch and the launch floor;
  4. full-width CpnU22 at 256^2 on the card against the same model on the
     CPU, TF32 off;
  5. the main path, ``CPN.forward_padded`` of full-width CpnU22 (backbone,
     heads, decode, refinement, NMS kernel) on 1024^2 tiles, fp32 at batch 1
     and bf16 at batch 4: throughput, a profile of one step (top kernels and
     the slowest convolutions by input shape), peak memory, detections before
     and after NMS, the kernel launches of that run, and the NMS kernels
     held against their plain versions and timed on that run's boxes. Every
     bf16 head conv of that run takes the heads' conv kernel
     (``csrc/head_conv.cu``) and no fp32 one does; the kernel is held against
     ``head_conv_plain`` on that run's own head inputs (the fused heads' and
     the refinement head's) and timed beside its bound, the plain version
     and cuDNN's heuristic choice. Phases 9, 15, 17, 19c and 21b run the
     main path the same way;
  6. tiled inference (``TiledInference``) of full-width CpnU22, fp32 with
     TF32 off, on a 640^2 mosaic in 256^2 tiles at stride 192: the card
     against the CPU (tiles, detections, contours);
  7. the gigapixel path, ``TiledInference`` of full-width CpnU22 with spread
     heads on blob mosaics (tile 1024, stride 768, ``max_outputs`` 400,000,
     as ``scripts/bench_gigapixel.py``): 8192^2 (121 tiles, the stitch's
     exact NMS over 247,808 rows) in bf16 at batch 4 and fp32 at batch 1,
     and 16,384^2 (441 tiles, the chunked NMS and its 'full' survivor pass)
     in bf16 at batch 4: tiles/s with the stitch and the readback, ms by
     stage and by NMS pass, survivors, detections, overflow, peak memory and
     the kernel launches of those runs; ``model(image)`` on a 2560^2 image
     (above ``max_imsize``) against ``TiledInference``; then the stitch's
     NMS on the same candidates against its plain version on the card, and
     each NMS pass of the stitch timed alone beside its bound (the 16,384^2
     cross-chunk pass at each survivor cap it took);
  8. the flagship, full-width and full-depth CpnResNeXt101UNet, and
     CpnResNet18FPN with three classes, each at 256^2 on the card against
     the same model on the CPU, TF32 off;
  9. the ResNet path: ``CPN.forward_padded`` of the flagship on 1024^2 tiles,
     fp32 at batch 1 and bf16 at batch 4, as phase 5 drives CpnU22 (the
     kernel launches of that run are ``launches_resnet``), then
     CpnResNet18FPN with three classes in bf16 at batch 4;
 10. ``TiledInference`` of the flagship on a 2048^2 blob mosaic (tile 1024,
     stride 768), bf16 at batch 4: tiles/s and ms by stage;
 11. training: (a) one ``make_train_step`` step of full-width CpnU22 at
     128^2, batch 2, K above the score map's pixels, on the card against the
     same step on the CPU, TF32 off (loss and each term, every gradient,
     the norms' running statistics); (b) ``scripts/bench_train.py``'s
     workload through ``CPNTrainer.fit``: full-width CpnU22, one input
     channel, 256^2, batch 8, 32 samples, K = 512, Adam at 5e-4, prefetch 1,
     32 images of 24 disks drawn with numpy; one warm-up epoch, then 3 timed:
     imgs/s end to end and for the device alone, host ms a batch for the
     targets, the device's idle share, peak memory and the 10 slowest
     device kernels of one step; (c) 30 steps on one fixed batch (the last
     loss below the first), then ``CPNTrainer.predict`` on two held-out
     256^2 images, which launches the NMS kernels (``launches_train``), and
     the NMS call of one predict forward held against its plain version and
     timed beside its bound;
 12. checkpoint I/O on the card: the trained CpnU12 of
     ``tests/fixtures/cpnu12_trained.cdt`` through the port's ``load_model``,
     on the card against the CPU under phase 4's gates; the flagship saved
     with ``save_model`` and loaded with ``load_model`` (file size, seconds,
     state dicts and forwards bit-equal); phase 11c's trainer saved with
     ``save_checkpoint``, loaded into a new ``CPNTrainer``, and one more
     epoch from both with ``cudnn.deterministic`` (losses bit-equal); none
     of msgpack, flax or h5py imported;
 13. validation: full-width CpnU22 with phase 11c's weights,
     ``fit(val_data=, val_every=1)`` and ``validate`` (with the
     channelled labels and with ``fast_labels``) over a sweep of 3 score and
     2 NMS thresholds on 4 held-out 512^2 disk images: each setting's
     ``f1_np`` and counts, ``best_hparams``, seconds per image and setting
     on the card and on the host, the NMS kernels' launches (one of each per
     image and setting, ``launches_validate``), and the card's counts and
     ``best_hparams`` against the CPU's, TF32 off;
 14. the rest of the zoo, card against CPU at 256^2 as phase 8: full-width and
     full-depth CpnConvNeXtBaseUNet, CpnConvNeXtV2TinyUNet (GRN),
     CpnDenseNet121UNet, CpnMobileNetV3LargeUNet, CpnMobileNetV3SmallFPN,
     CpnResNet50MaNet (PAB and MFAB), CpnResUNet and CpnWideU22, random
     weights tamed (``ZOO_CHECK``); then a synthetic torchvision ConvNeXt-Tiny
     state dict written to a temporary ``.pth`` and loaded through
     ``backbone_kwargs={'pretrained': path}`` on the card and the CPU
     (encoders bit-equal, the stem adapted to one channel);
 15. the zoo's main path on 1024^2 tiles as phase 5: CpnConvNeXtBaseUNet in
     fp32 at batch 1 and bf16 at batch 4, CpnConvNeXtLargeUNet (its heads
     over 192 channels, on the head conv kernel's BN = 64 tiles),
     CpnDenseNet121UNet, CpnMobileNetV3LargeFPN and CpnResNet50MaNet in bf16
     at batch 4 (the kernel launches of these runs are ``launches_zoo``);
 16. the batch inference CLI: CpnU22 saved with ``save_model``, loaded by
     ``tiled_models``, ``infer_input`` on a 4096^2 uint8 blob mosaic four ways
     (``launches_cli``), then card against CPU on 640^2;
 17. CpnU22 with every head option, card against CPU at 256^2 and on 1024^2
     tiles (``launches_heads``);
 18. two ranks of ``torch.distributed`` on the one card over gloo, each a
     process of its own: (a) ``make_train_step`` over the mesh on phase
     11b's workload, 3 steps at K = 65,536 (TF32 and dropout off) with the
     ranks' parameters bit-identical and the losses against one process on
     the union batch, then 20 timed steps at K = 512 (imgs/s, ms a step, the
     gradient all-reduce, peak memory); (b) ``multihost_tiled_inference`` of
     phase 7's 8192^2 mosaic in fp32 at batch 1 (ms by stage, the exchange's
     bytes, every NMS call held against its plain version and timed; the
     kernel launches of that run are ``launches_ddp``), its result the same
     on both ranks and against phase 7's; (c) ``validate(distributed=True)``
     on phase 13's images against phase 13; (d) ``cpn_inference`` on phase
     16's mosaic under ``'rank'`` and ``'job'`` against 16a's outputs, one
     writer an input;
 19. the demos' recipes and the Mamba path on the port's own modules:
     (a) the binary demo: ``Config``, ``SynthTrain`` (64 images of 256^2)
     through ``conf2augmentation`` with the elastic warp, ``CPNTrainer.fit``
     of full-width CpnU22 at batch 8 (one warm-up epoch, two timed: imgs/s
     end to end, host ms a batch in augmentation and in targets, peak
     memory), then ``TiledInference`` on a 768^2 ``random_geometric_objects``
     mosaic with every NMS call held against the plain versions (the kernel
     launches of that run are ``launches_demo``); (b) the multiclass demo:
     ``random_geometric_shapes``, 4 classes, 6 refinement buckets,
     ``conf2tweaks_`` of the norms' momentum to 0.05 after the trainer is
     built, Adadelta with ``StepLR``, and the running statistics of one step
     against flax's update worked out on the card; (c) ``selective_scan``
     (the fused kernel, ``csrc/selective_scan.cu``) against a float64
     sequential scan within 1e-5 + 1e-4 |ref| at 2 x 1003 x 8 and at the
     Mamba CPN's four stage shapes on a 1024^2 tile (65,536 x 512 to 1024 x
     4096, d_state 16), then full-width CpnResNet50UNet with
     a ``MambaLayer`` after every stage card against CPU at 256^2 and on
     512^2 tiles as phase 5 (fp32 batch 1, bf16 batch 4; the NMS kernel launches
     of that run are ``launches_mamba``; the fp32 run's scans must take the
     fused kernel, the bf16 run's the torch scan), with the scan's share of the
     forward; then the model in bf16 at batch 4 held against fp32 on the
     same inputs (4 toy images of 512^2) under the bf16 gates of the CPU
     tests (counts within 8%, 92% of the fp32 boxes matched at IoU 0.8, their
     contours within 0.5 px on average) and the dense score logits' 99th
     percentile of |bf16 - fp32| within 0.12 of their spread, before
     NMS, after 12 training steps on toy images and with trained-like scores
     (the score head shifted and scaled so that a wide gap of the fp32 logits
     falls on the threshold, as ``tests/test_torch_port_mamba.py`` does);
 20. the utilities on full-width CpnU22 and phase 5's inputs: (a) the NMS
     entry points ``ops.boxes.nms`` on a 2048-box image of a 1024^2 forward
     and ``batched_box_nmsi`` on three lists of 20,000 random boxes
     (``batch_size`` 5000), on the card, each bit-equal to its plain run on
     the CPU (the kernel launches of that run are ``launches_utils``), and
     each kernel of both held against its plain version and timed as in
     phase 3;
     (b) ``ops.draw.draw_contours`` of that forward's [2048, 32, 2] contours
     on a 1024^2 canvas, card against CPU; (c) one epoch of phase 11b's fit
     with ``MetricsLogger``: one JSON line a step, the last equal to the
     trainer's history; (d) ``Timer(sync=True)`` around five forwards beside
     CUDA events, ``GpuStats``, ``get_total_memory`` against the device's
     properties, and ``OomCatcher`` through a real out-of-memory error (twice
     the card's memory, then a quarter of that); (e) three Adam steps under
     ``frozen_optimizer`` with the encoder frozen (its parameters bit
     unchanged) and ``ema_update`` on the card against the CPU;
 21. the rest of ``models/commons.py``, heads on encoder levels and 3-D
     backbones: (a) U22 and the ResNet50 UNet built with ``nd=3`` at their
     default widths on 1 x 1 x 128^3 volumes, fp32 at batch 1 and bf16 at
     batch 2 (ms a forward, peak memory), then card against CPU on 32^3
     volumes, TF32 off, every map within 1e-4 of its peak: those two, and
     at narrow widths the ResNet18 FPN, ConvNeXt, DenseNet, MobileNetV3Small,
     ``Ppm`` and the MaNet blocks; (b) CpnU22 with ``contour_features=('1',
     'encoder.1')`` and ``score_features='encoder.1'``, card against CPU at
     256^2 as phase 4 and through the main path on 1024^2 tiles as phase 5
     (the kernel launches of that run are ``launches_encoder_heads``); (c)
     ``SelfAttention`` at 64^2, ``SqueezeExcitation``, ``LayerNorm2d``,
     ``DynamicTanh``, ``BottleneckBlock`` and ``MinibatchStdLayer``, card
     against CPU, TF32 off, within 1e-4 of each output's peak.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import celldetection_tpu_torch as ct
from celldetection_tpu_torch import models
from celldetection_tpu_torch.kernels import LAUNCHES, nms_bits_count, nms_bits_fill, nms_resolve
from celldetection_tpu_torch.kernels import nms as knms
from celldetection_tpu_torch.kernels.head_conv import (head_conv_kernel, head_conv_library,
                                                       head_conv_plain)
from celldetection_tpu_torch.kernels.selective_scan import selective_scan_library
from celldetection_tpu_torch.kernels.nms import (BLOCK, _nms_sweep, _resolve_blocks,
                                                 _suppression_counts, _suppression_matrix,
                                                 _suppression_pairs, band_plan, bits_library,
                                                 large_layout, nms_sweep, resolve_library,
                                                 slots_layout)
from celldetection_tpu_torch.ops.boxes import box_iou, nms_chunked, nms_padded, sort_by_score
from celldetection_tpu_torch.data import (collate_cpn_targets, conf2augmentation, contours2labels,
                                          cpn_targets_single, random_geometric_objects,
                                          random_geometric_shapes)
from celldetection_tpu_torch.data.datasets import SynthTrain
from celldetection_tpu_torch.models import commons, mamba
from celldetection_tpu_torch.native import contours2labels_native, rasterize_library
from celldetection_tpu_torch.parallel.tiles import TiledInference, tile_image
from celldetection_tpu_torch.parallel.train import TrainState, make_train_step
from celldetection_tpu_torch.runtime.cpn_inference import infer_input, preprocess, tiled_models
from celldetection_tpu_torch.runtime.trainer import CPNTrainer
from celldetection_tpu_torch.util.config import conf2optimizer
from celldetection_tpu_torch.util import spans as span_recorder
from celldetection_tpu_torch.util import surgery, system, timer
from celldetection_tpu_torch.util.logging import MetricsLogger
from celldetection_tpu_torch.util.serialization import load_model, load_model_meta, save_model
from celldetection_tpu_torch.util.weights import body_layout, init_jax_variables, state_dict_from_jax

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
TILE = 1024          # main-path tile side (the reference CLI's default tile)
CHECK_SIZE = 256     # side of the card-vs-CPU check
# the flagship as bench.py:36 and scripts/profile_flagship.py:63 build it:
# order 5, 32 samples, K = 2048, 4 refinement loops, NMS threshold 0.2
FLAGSHIP = dict(order=5, samples=32, max_detections=2048, refinement_iterations=4,
                nms_thresh=0.2)
# the training workload of scripts/bench_train.py:29-80 (CpnU22, one channel)
TRAIN = dict(samples=32, max_detections=512)
TRAIN_SIZE, TRAIN_BATCH, TRAIN_IMAGES = 256, 8, 32
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12   # dense bf16 on the tensor cores
# fp32 operations of one box-pair test (csrc/nms_bits.cu:suppresses): 4 min/max,
# 2 sub, 2 clamps, inter mul, union add and sub, thresh mul, select, compare.
PAIR_TEST_OPS = 14
# ... and of a pair whose boxes lie apart on an axis (csrc/nms_bits.cu:apart,
# the bits kernels' exact early-out): 4 compares.
APART_OPS = 4
SCRATCH_LIMIT = 256 * 2 ** 20   # bytes the NMS sweep may allocate at any phase-3 shape
SOURCES = {'nms_bits_count': 'nms_bits.cu', 'nms_bits_fill': 'nms_bits.cu',
           'nms_resolve': 'nms_resolve.cu'}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'chip_smoke: {msg}')


def card_line(query='name,power.limit') -> str:
    out = subprocess.run(['nvidia-smi', f'--query-gpu={query}', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def crowded_boxes(rng, batch, n, extent, invalid=0.05):
    centers = rng.rand(batch, n, 2) * extent
    sizes = rng.rand(batch, n, 2) * 20 + 2
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], -1).astype(np.float32)
    return boxes, rng.rand(batch, n).astype(np.float32), rng.rand(batch, n) > invalid


def knife_edge_pairs(rng, thresh, pairs=512):
    """Pairs whose IoU is exactly ``thresh`` in real arithmetic: a box and its
    own left part of relative width ``thresh``. The first pairs have integer
    corners (10 wide, so the part is 2, 5 or 8 wide); the rest sit at random
    fractional positions. Pairs lie 100 px apart on a grid."""
    gx, gy = np.divmod(np.arange(pairs), 32)
    x = 100. * gx + rng.rand(pairs) * 50
    y = 100. * gy + rng.rand(pairs) * 50
    w = rng.rand(pairs) * 30 + 1
    h = rng.rand(pairs) * 30 + 1
    x[:16], y[:16] = np.floor(x[:16]), np.floor(y[:16])
    w[:16], h[:16] = 10., np.floor(h[:16]) + 1
    a = np.stack([x, y, x + w, y + h], -1)
    b = np.stack([x, y, x + w * thresh, y + h], -1)
    boxes = np.stack([a, b], 1).reshape(1, 2 * pairs, 4).astype(np.float32)
    return boxes, rng.rand(1, 2 * pairs).astype(np.float32), np.ones((1, 2 * pairs), bool)


def nms_bound(b, v, keep, thresh):
    """Least time (ms) for greedy NMS on these score-sorted inputs, and what bounds it.

    Bytes: each box and valid flag read once, the keep mask written once.
    Operations: the pair tests this data needs: a kept box is tested against
    every kept box before it (k kept boxes: k (k - 1) / 2 tests), a suppressed
    one up to its first kept suppressor. Only the suppressed columns are
    tested against the kept rows, in chunks, so the temporaries stay small.
    """
    bsz, n = v.shape
    nbytes = bsz * n * (16 + 1 + 1)
    tests = 0
    for i in range(bsz):
        kept = keep[i].nonzero()[:, 0]                  # kept rows, in order
        if not len(kept):
            continue
        tests += len(kept) * (len(kept) - 1) // 2
        gone = (v[i] & ~keep[i]).nonzero()[:, 0]        # valid and suppressed
        step = max(BLOCK, 2 ** 26 // len(kept))
        for c0 in range(0, len(gone), step):
            cols = gone[c0:c0 + step]
            sup = _suppression_matrix(b[i, kept], b[i, cols], thresh)
            sup &= kept[:, None] < cols[None, :]
            first = sup.to(torch.uint8).argmax(0)       # place of the first kept suppressor
            tests += int(torch.where(sup.any(0), first + 1, 0).sum())
    ops = tests * PAIR_TEST_OPS
    return bound_of(nbytes, ops) + (tests,)


def bound_of(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else 'operations')


def kernel_bounds(b, v, keep, pairs, slots):
    """Least time (ms) of each NMS kernel's own function on these inputs, in
    the layout ``bits_sweep`` takes, and what bounds it.

    Operations: a pair test takes ``PAIR_TEST_OPS``, or ``APART_OPS`` where the
    boxes lie apart on an axis; every valid row is tested against every later
    valid column once in all: in the slots layout the count tests the pairs
    inside the diagonal blocks and the fill the rest; packed, the count tests
    all of them and the fill again those of block pairs that hold a word.
    Bytes, each input read once and each output written once: the count reads
    the boxes and valid flags and writes the column words and, packed, the
    counts, next words and block flags; the fill reads the boxes and valid
    flags (packed: and the block flags and offsets) and writes its room of
    pairs (slots: every slot); the resolve reads the column words and the
    kept rows' later words (packed: their pairs, the next words among them,
    and two offsets a block; slots: every slot of a kept row, zero or not),
    and writes the keep mask. ``pairs``: the plain version's, the non-zero
    words. ``[M, M]`` temporaries: for the main path's 2048 boxes.
    """
    bsz, m = v.shape
    nb = -(-m // BLOCK)
    rows = nb * bsz * BLOCK
    blk = torch.arange(m, device=v.device) // BLOCK
    same = blk[:, None] == blk[None, :]
    row = pairs[:, 1] & 0xffffffff
    flags = torch.zeros(bsz, nb, nb, dtype=torch.bool, device=v.device)
    flags[row // m, row % m // BLOCK, pairs[:, 1] >> 32] = True    # block pairs holding a word
    ops = {'count': 0, 'fill': 0}
    for i in range(bsz):
        x0, y0, x1, y1 = b[i].unbind(-1)
        apart = ((x0[None, :] >= x1[:, None]) | (x0[:, None] >= x1[None, :])
                 | (y0[None, :] >= y1[:, None]) | (y0[:, None] >= y1[None, :]))
        later = torch.ones(m, m, dtype=torch.bool, device=v.device).triu(1)
        later &= v[i][:, None] & v[i][None, :]
        diagonal, off = later & same, later & ~same
        flagged = off & flags[i][blk[:, None], blk[None, :]]
        tested = ((('count', diagonal), ('fill', off)) if slots else
                  (('count', later), ('fill', flagged)))
        for name, tests in tested:
            n_apart = int((tests & apart).sum())
            ops[name] += n_apart * APART_OPS + (int(tests.sum()) - n_apart) * PAIR_TEST_OPS
    kept_pairs = int(keep.flatten()[row].sum())
    kept_slots = int((keep.long() * (nb - 1 - blk)).sum())  # a kept row's later words
    boxes_in = bsz * m * (16 + 1)
    n_flags = bsz * nb * nb
    if slots:
        room = bsz * BLOCK * nb * (nb - 1) // 2
        return {'nms_bits_count': bound_of(boxes_in + rows * 8, ops['count']),
                'nms_bits_fill': bound_of(boxes_in + room * 16, ops['fill']),
                'nms_resolve': bound_of(rows * 8 + kept_slots * 16 + bsz * m, 0)}
    return {'nms_bits_count': bound_of(boxes_in + 2 * rows * 8 + (rows + 1) * 8 + n_flags,
                                       ops['count']),
            'nms_bits_fill': bound_of(boxes_in + n_flags + (rows + 1) * 8 + len(pairs) * 16,
                                      ops['fill']),
            'nms_resolve': bound_of(rows * 8 + 2 * bsz * nb * 8 + kept_pairs * 16 + bsz * m, 0)}


def max_err(got, want):
    """max |got - want| over integer or bool tensors; at least 1 where they differ."""
    check(got.shape == want.shape, f'shapes differ: {tuple(got.shape)} and {tuple(want.shape)}')
    if torch.equal(got, want):
        return 0.
    return max(1., float((got.double() - want.double()).abs().max()))


def canonical(pairs, shape):
    """Pairs ordered by block-major row and word, as the plain version orders
    them (the kernel's order inside a row is not fixed)."""
    bsz, m = shape
    row = pairs[:, 1] & 0xffffffff
    q = ((row % m) // BLOCK * bsz + row // m) * BLOCK + row % m % BLOCK
    return pairs[torch.argsort((q << 32) | (pairs[:, 1] >> 32))]


def hold_each(b, v, thresh, errs):
    """Each NMS kernel against its plain version on the card, in the layout
    and bands that ``bits_sweep`` takes for these inputs (``slots_layout``,
    ``band_plan``), on the inputs the kernels before it gave. Raises unless
    all agree bit for bit; keeps the largest |kernel - plain| of each kernel
    in ``errs``. Returns the keep mask, the rows' offsets, the layout and the
    bands."""
    bsz, m = v.shape
    nb = -(-m // BLOCK)
    large = large_layout(m)
    slots = not large and slots_layout(bsz, m)
    want = _suppression_counts(b, v, thresh, large)
    start, diag, flags, nxt = nms_bits_count(b, v, thresh, packed=not slots, large=large)
    found = {'nms_bits_count': max(max_err(got, w) for got, w in
                                   zip((start, diag, flags, nxt), want) if got is not None)}
    if not slots:
        start.cumsum_(0)
    bands = band_plan(start, bsz, m)
    offsets = want[0].cumsum(0)                         # the plain offsets, for the records
    removed, want_removed = (torch.zeros(bsz, nb, dtype=torch.int64, device=b.device)
                             for _ in range(2))
    keep, want_keep = torch.zeros_like(v), torch.zeros_like(v)
    for r0, r1, base, size in bands:
        pairs = nms_bits_fill(b, v, thresh, r0, r1, flags, start, base, size, large)
        nms_resolve(v, diag, nxt, pairs, start, base, removed, keep, r0, r1, large)
        # slots: the zero slots are no pairs; packed: the room past the band's pairs is unwritten
        pairs = (pairs[pairs[:, 0] != 0] if slots
                 else pairs[:int(offsets[r1 * bsz * BLOCK]) - base])
        err = max_err(canonical(pairs, v.shape), _suppression_pairs(b, v, thresh, r0, r1))
        found['nms_bits_fill'] = max(found.get('nms_bits_fill', 0.), err)
        _resolve_blocks(v, diag, pairs, want_removed, want_keep, r0, r1)
        err = max(max_err(keep, want_keep), max_err(removed, want_removed))
        found['nms_resolve'] = max(found.get('nms_resolve', 0.), err)
    for name, err in found.items():
        check(err == 0., f'{name} and its plain version differ ({err})')
        errs[name] = max(errs.get(name, 0.), err)
    return keep, offsets, slots, bands


LAUNCH_NAMES = {'cdt_nms_bits_count': 'nms_bits_count', 'cdt_nms_bits_fill': 'nms_bits_fill',
                'cdt_nms_resolve': 'nms_resolve'}


def nms_launches():
    """Each NMS kernel's launches so far (``kernels.LAUNCHES``), by its wrapper's name."""
    return {short: LAUNCHES[name] for name, short in LAUNCH_NAMES.items()}


HOLD_CYCLES = 200_000       # a device-side wait of about 0.1 ms ahead of each timed launch
EVENTS = 'CUDA events around each launch'


def event_ms(fn, calls):
    """Device time (ms) per launch of each NMS kernel over ``calls`` calls of
    ``fn``, from CUDA events recorded just before and after each launch on
    its stream (``kernels.nms.launch`` wrapped), with its launches per call
    (``torch.profiler`` misses kernels late in a long process). Ahead of each launch the
    stream waits on the device (``torch.cuda._sleep``) while the host queues
    the event, the kernel and the second event, so the span holds the
    kernel and the events' own few microseconds, not the host's launch; the
    median span is taken, as a host stalled past the wait stretches one.
    It fails when a kernel was not launched at least once a call."""
    original = knms.launch
    spans = {name: [] for name in LAUNCH_NAMES.values()}

    def timed(built, name, device, *args):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        a.record()
        original(built, name, device, *args)
        b.record()
        spans[LAUNCH_NAMES[name]].append((a, b))

    fn()
    torch.cuda.synchronize()
    knms.launch = timed
    try:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    finally:
        knms.launch = original
    check(all(len(ev) >= calls for ev in spans.values()),
          f'event timing: launches per call {({k: len(ev) / calls for k, ev in spans.items()})}')
    out = {name: (float(np.median([a.elapsed_time(b) for a, b in ev])), round(len(ev) / calls))
           for name, ev in spans.items()}
    check(all(ms > 0. for ms, _ in out.values()), f'event timing: {out}')
    return out


def launch_floor_ms():
    """Time per launch of an empty kernel on the current stream, back to back (CUDA events)."""
    lib = resolve_library().lib
    stream = torch.cuda.current_stream().cuda_stream
    return cuda_ms(lambda: lib.cdt_empty_launch(stream), 2000, warmup=100)


def time_sweep(label, b, v, keep, thresh, card, floor):
    """The sweep's time per call and per kernel at one shape, beside its bound.
    Returns the ms per call and, per kernel, its device ms per launch, its
    launches per call and how the device time was taken."""
    t0 = time.perf_counter()
    nms_sweep(b, v, thresh)
    torch.cuda.synchronize()
    iters = max(3, min(200, int(0.5 / (time.perf_counter() - t0))))
    windows = sorted(cuda_ms(lambda: nms_sweep(b, v, thresh), iters) for _ in range(3))
    ms = windows[1]                     # the median of three windows; the host's share varies
    clocks = card_line('clocks.sm,power.draw,temperature.gpu')   # right after the windows
    t0 = time.perf_counter()
    for _ in range(iters):
        nms_sweep(b, v, thresh)
    host_ms = (time.perf_counter() - t0) / iters * 1e3
    dev = event_ms(lambda: nms_sweep(b, v, thresh), min(iters, 10))
    before = sum(nms_launches().values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    nms_sweep(b, v, thresh)
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated() - held
    per_call = sum(nms_launches().values()) - before
    bound_ms, bound_by, tests = nms_bound(b, v, keep, thresh)
    kernels_ms = ', '.join(f'{name} {dev[name][0]:.4f} ms x{dev[name][1]}' for name in SOURCES)
    print(f'  [{card}] nms_sweep {label}: {ms:.4f} ms per call (median of 3 windows of {iters} '
          f'calls, {windows[0]:.4f}-{windows[2]:.4f}; CUDA events), '
          f'host {host_ms:.4f} ms per call (host clock, no synchronisation); on the device '
          f'{kernels_ms} ({EVENTS}); {per_call} kernel launches per call, '
          f'launch floor {floor:.4f} ms; bound {bound_ms:.6f} ms ({bound_by}; {tests} pair '
          f'tests); peak scratch {scratch / 2 ** 20:.1f} MiB; library call: none; SM clock, '
          f'power, temperature after the windows: {clocks}', flush=True)
    check(scratch <= SCRATCH_LIMIT, f'{label}: scratch {scratch} bytes above {SCRATCH_LIMIT}')
    return ms, dev


def time_forward_nms(label, model, x, errs, card, floor):
    """The NMS call of one forward of ``model`` on NHWC ``x``: each kernel held
    against its plain version, the sweep timed beside its bound and the plain
    sweep (phases 11c and 13)."""
    pre = model.forward_padded(x, nms=False)
    t = model.nms_thresh
    _, b, v = sort_by_score(pre['boxes'], pre['scores'], pre['valid'])
    k, _, _, _ = hold_each(b, v, t, errs)
    check(torch.equal(k, _nms_sweep(b, v, t)), f'{label}: the sweep and plain differ')
    shape = f'B={v.shape[0]} N={v.shape[1]}'
    ms, _ = time_sweep(f'{shape} t={t} ({label}, {int(v.sum())} valid)', b, v, k, t, card, floor)
    plain_ms = cuda_ms(lambda: _nms_sweep(b, v, t), 3, warmup=1)
    print(f'  [{card}] plain _nms_sweep {shape} ({label}): {plain_ms:.3f} ms; nms_sweep '
          f'{ms:.4f} ms', flush=True)


def to_dev(arrays, device):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


def random_weights(model, tame=False, score=1., fourier=1.):
    """Seeded random weights for ``model`` (numpy seed ``SEED``) as its state dict.

    ``tame``: for deep residual encoders, whose random activations grow
    block by block until the score sigmoid saturates at exactly 1 (no
    threshold gap, no ranking): the last norm of every residual branch (a
    ResNet block's, a MobileNetV3 block's ``project_bn``) is scaled by 0.1,
    a secondary ``MambaLayer``'s output projection by 0.01,
    the score head's output layer by 0.25 and the refinement head's by 0.01
    (its logits would otherwise saturate ``3 tanh``).
    ``score``, ``fourier``: further factors on those heads' output layers.
    """
    variables = init_jax_variables(model, SEED)
    params = variables['params']
    if tame:
        for layer, blocks in params['backbone']['body'].items():
            if layer.startswith('layer'):
                for block in blocks.values():
                    last = block['bn3' if 'bn3' in block else 'bn2']['norm']
                    last.update({k: v * np.float32(0.1) for k, v in last.items()})
            elif layer.startswith('block') and 'project_bn' in blocks:
                last = blocks['project_bn']['norm']
                last.update({k: v * np.float32(0.1) for k, v in last.items()})
            elif layer.startswith('secondary'):      # a Mamba's scan sums thousands of tokens
                blocks['mamba']['out_proj']['kernel'] *= np.float32(0.01)
        score *= 0.25
        params['refinement_head']['conv1']['kernel'] *= np.float32(0.01)
        params['refinement_head']['conv1']['bias'] *= np.float32(0.01)
    for head, factor in (('score_head', score), ('fourier_head', fourier)):
        if factor != 1.:
            params[head]['conv1']['kernel'] *= np.float32(factor)
    return state_dict_from_jax(variables, body_layout(model)[1])


def threshold_above(probs, count):
    """The largest score threshold that leaves at least ``count`` pixels of
    every image of ``probs [B, ...]`` above it (ties at the cut included)."""
    flat = probs.reshape(probs.shape[0], -1).float()
    cut = torch.topk(flat, count, dim=1).values[:, -1:]
    return float(torch.where(flat < cut, flat, -1.).amax(1).min())


def threshold_in_gap(probs, lo, hi):
    """A score threshold in the widest gap of the sorted probabilities that
    leaves between ``lo`` and ``hi`` pixels above it; returns (threshold, gap)."""
    s = np.sort(probs.ravel().astype(np.float64))[::-1]
    gaps = s[lo - 1:hi - 1] - s[lo:hi]
    i = lo - 1 + int(np.argmax(gaps))                   # s[i] > t > s[i + 1]
    return float((s[i] + s[i + 1]) / 2), float(gaps.max())


def profile_step(step, label, top=12):
    """Where one step's device time goes: ``torch.profiler`` over one call,
    the device kernels' share of the step's wall time, the ``top`` kernels
    and the convolutions (input and weight shapes) that take the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device rows named aten::* are the GPU-side spans of operators, which
    # overlap the kernels they launch: counting them too would count twice (so
    # would the GPU-side spans of annotations such as Optimizer.step#Adam.step)
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and not e.key.startswith('aten::')
                   and '#' not in e.key), reverse=True)
    busy = sum(r[0] for r in rows)
    print(f'  {label} profile: device kernels {busy:.2f} ms in a {wall_ms:.2f} ms step '
          f'(busy share {busy / wall_ms:.3f}, profiler on)', flush=True)
    for ms, count, key in rows[:top]:
        print(f'    {ms:9.3f} ms  {100 * ms / busy:5.1f}%  x{count:<5d} {key[:90]}', flush=True)
    convs = sorted(((e.device_time_total / 1e3, e.count, e.input_shapes)
                    for e in prof.key_averages(group_by_input_shape=True)
                    if e.key == 'aten::cudnn_convolution' and e.device_type == DeviceType.CPU),
                   key=lambda r: r[0], reverse=True)
    for ms, count, shapes in convs[:3]:
        print(f'    convolution {ms:9.3f} ms  x{count:<3d} input, weight: {shapes[:2]}', flush=True)


def phase_kernels(rng, card, errs):
    """Phase 3: the NMS kernels against their plain versions, bit-equal, on the card."""
    print('== phase 3: NMS kernels vs plain versions on the card (bit-equal)', flush=True)
    floor = launch_floor_ms()
    print(f'  [{card}] launch floor: {floor:.4f} ms per empty kernel launch on the same stream '
          f'(CUDA events, 2000 back to back)', flush=True)
    cases = []
    for t in (0.2, 0.5, 0.8):
        cases.append((f'B=4 N=2048 t={t}', crowded_boxes(rng, 4, 2048, 200.), t))
    cases.append(('B=1 N=16384 t=0.5', crowded_boxes(rng, 1, 16384, 800.), 0.5))
    cases.append(('B=2 N=300 t=0.5', crowded_boxes(rng, 2, 300, 100.), 0.5))
    cases.append(('B=1 N=1 t=0.5', crowded_boxes(rng, 1, 1, 10., invalid=0.), 0.5))
    bx, sc, _ = crowded_boxes(rng, 2, 500, 100.)
    cases.append(('B=2 N=500 all invalid t=0.5', (bx, sc, np.zeros((2, 500), bool)), 0.5))
    for t in (0.2, 0.5, 0.8):
        cases.append((f'knife-edge 512 pairs IoU=t={t}', knife_edge_pairs(rng, t), t))
    # stitch scale, at the density of the N=16384 case: nms_chunked's per-chunk
    # pass on a 16,384^2 mosaic (441 tiles x 2048 slots in chunks of 16,384),
    # and one image of 262,144 boxes, the JAX package's largest exact NMS. A
    # generator of their own leaves the later phases' inputs as they were.
    stitch = np.random.RandomState(SEED + 1)
    cases.append(('B=1 N=2048 t=0.5', crowded_boxes(stitch, 1, 2048, 200.), 0.5))
    cases.append(('B=56 N=16384 t=0.5', crowded_boxes(stitch, 56, 16384, 800.), 0.5))
    cases.append(('B=1 N=262144 t=0.5', crowded_boxes(stitch, 1, 262144, 3200.), 0.5))
    # the smallest image of the large layout (bit flags, the resolve's variant)
    cases.append(('B=1 N=262145 t=0.5', crowded_boxes(stitch, 1, 262145, 3200.), 0.5))
    timed = ('B=4 N=2048 t=0.2', 'B=1 N=2048 t=0.5', 'B=1 N=16384 t=0.5', 'B=56 N=16384 t=0.5',
             'B=1 N=262144 t=0.5', 'B=1 N=262145 t=0.5')
    for label, arrays, t in cases:
        boxes, scores, valid = to_dev(arrays, 'cuda')
        _, b, v = sort_by_score(boxes, scores, valid)
        keep, start, slots, bands = hold_each(b, v, t, errs)
        k = nms_sweep(b, v, t)
        start_ev, end_ev = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start_ev.record()
        p = _nms_sweep(b, v, t)
        end_ev.record()
        end_ev.synchronize()
        plain_ms = start_ev.elapsed_time(end_ev)            # the first call, warm from hold_each
        check(torch.equal(k, p) and torch.equal(keep, p), f'{label}: the sweep and plain differ')
        layout = 'slots' if slots else 'large' if large_layout(v.shape[1]) else 'packed'
        line = (f'  {label}: kept {int(k.sum())} of {int(v.sum())} valid, {int(start[-1])} pairs '
                f'in {len(bands)} band(s), {layout} layout; '
                f'each kernel == plain, sweep == _nms_sweep')
        if v.shape[1] <= 16384 and v.shape[0] <= 4:  # the CPU's plain sweep takes minutes above
            end_to_end = nms_padded(boxes, scores, valid, t).cpu()
            cpu = nms_padded(*to_dev(arrays, 'cpu'), t)
            check(torch.equal(end_to_end, cpu), f'{label}: nms_padded on card and CPU differ')
            check(not bool(end_to_end[~valid.cpu()].any()), f'{label}: an invalid box was kept')
            line += ', nms_padded card == cpu'
        print(line, flush=True)
        if label in timed:
            if v.shape[1] <= 16384:
                plain_ms = cuda_ms(lambda: _nms_sweep(b, v, t), 2, warmup=0)
            time_sweep(label, b, v, k, t, card, floor)
            print(f'  [{card}] plain _nms_sweep {label}: {plain_ms:.3f} ms', flush=True)
    return floor


def phase_card_vs_cpu(rng, title, build, tame=False, image=None, counts=(500, 2048), score=1.,
                      fourier=1.):
    """The model ``build(device=...)`` makes at 256^2, the card against the
    CPU, TF32 off: dense heads, valid sets before and after NMS, classes and
    contours (phases 4, 8, 12 and 14). The models get seeded random weights
    (``random_weights(tame, score, fourier)``) unless ``image`` (``[1, 256,
    256, C]``) is given: then they hold their own. The score threshold
    leaves ``counts`` pixels above it."""
    print(f'== {title} at {CHECK_SIZE}^2, card vs CPU, TF32 off', flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu_m = build(device='cpu')
    gpu_m = build()
    if image is None:
        sd = random_weights(cpu_m, tame, score, fourier)
        cpu_m.load_state_dict(sd, strict=True)
        gpu_m.load_state_dict(sd, strict=True)
        image = rng.rand(1, CHECK_SIZE, CHECK_SIZE, 3).astype(np.float32)
    x = torch.from_numpy(image)
    t0 = time.perf_counter()
    with torch.no_grad():
        dc = cpu_m.core(x)
    cpu_s = time.perf_counter() - t0
    with torch.no_grad():
        dg = {k: v.cpu() for k, v in gpu_m.core(x.cuda()).items() if v is not None}
    # fp32 convolutions summed in another order by cuDNN and the CPU library,
    # through the whole backbone and the 7x7 heads: 1e-3 of each map's
    # magnitude (the refinement map is 3 * tanh of logits many times larger
    # than itself).
    for key, v in dg.items():
        err = float((v - dc[key]).abs().max())
        tol = 1e-3 * max(1., float(dc[key].abs().max()))
        print(f'  dense {key} {tuple(v.shape)}: max |card - cpu| = {err:.3e} (atol {tol:.3e})',
              flush=True)
        check(err <= tol, f'dense {key} differs: {err} > {tol}')
    if 'uncertainty' in dg:
        # the certainty cut in a wide gap of the CPU's mean uncertainties (a
        # fifth to four fifths of the pixels kept), so no pixel lies within
        # the card-CPU difference of it
        u_cpu = dc['uncertainty'].mean(-1)
        u_err = float((dg['uncertainty'].mean(-1) - u_cpu).abs().max())
        cut, u_gap = threshold_in_gap(-u_cpu.numpy(), u_cpu.numel() // 5, 4 * u_cpu.numel() // 5)
        check(u_gap > 4 * u_err, f'uncertainty gap {u_gap} too narrow for the card-cpu '
                                 f'difference {u_err}')
        for m in (cpu_m, gpu_m):
            m.certainty_thresh = 1 + cut          # keeps mean uncertainty below -cut
        print(f'  certainty_thresh {1 + cut:.6f} (gap {u_gap:.2e}, mean uncertainty diff '
              f'{u_err:.2e})', flush=True)
    if gpu_m.score_channels > 2:
        # classes are the argmax of the logits, and no threshold can be placed
        # in a gap: a pixel whose two largest logits lie within 4x the
        # card-CPU difference may take either class on either side, and only
        # such pixels may be foreground on one side alone
        top2 = dc['scores'].topk(2, -1).values
        margin = (top2[..., 0] - top2[..., 1]).flatten()
        p_err = float((dg['scores'] - dc['scores']).abs().max())
        ambiguous = set((margin <= 4 * p_err).nonzero()[:, 0].tolist())
        thresh, gap = None, float(margin.min())
        check(len(ambiguous) <= 0.01 * len(margin), f'{len(ambiguous)} pixels near a class tie')
    else:
        p_cpu = torch.sigmoid(dc['scores'])
        p_err = float((torch.sigmoid(dg['scores']) - p_cpu).abs().max())
        thresh, gap = threshold_in_gap(p_cpu.numpy(), *counts)
        ambiguous = set()
        check(gap > 4 * p_err, f'score gap {gap} too narrow for the card-cpu difference {p_err}')
    outs = {}
    for nms in (False, True):
        t0 = time.perf_counter()
        oc = cpu_m.forward_padded(x, score_thresh=thresh, nms=nms)
        cpu_s += time.perf_counter() - t0
        og = gpu_m.forward_padded(x.cuda(), score_thresh=thresh, nms=nms)
        outs[nms] = (oc, {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in og.items()})
    (pre_c, pre_g), (post_c, post_g) = outs[False], outs[True]

    def pixels(o):
        return set(o['fg_index'][0][o['valid'][0]].tolist())

    pre_sym = pixels(pre_c) ^ pixels(pre_g)
    check(pre_sym <= ambiguous, 'pre-NMS valid sets differ')
    sym = pixels(post_c) ^ pixels(post_g)
    print(f'  threshold {thresh} (gap {gap:.2e}, score diff {p_err:.2e}, {len(ambiguous)} '
          f'pixels near a class tie; CPU forwards {cpu_s:.1f} s): {len(pixels(pre_c))} valid '
          f'before NMS on the CPU, {len(pre_sym)} on one side alone; kept cpu '
          f'{len(pixels(post_c))}, card {len(pixels(post_g))}, differing {len(sym)}', flush=True)
    check(len(sym) <= 0.01 * len(pixels(post_c)), f'{len(sym)} kept boxes differ')
    # contours and classes per pixel selected on both sides: the orders may
    # differ on near-equal scores; the classes of pixels near a tie may differ
    cc, cg = pre_c['contours'][0], pre_g['contours'][0]
    ic = {p: i for i, p in enumerate(pre_c['fg_index'][0].tolist())}
    sel = [i for i in pre_g['valid'][0].nonzero()[:, 0].tolist()
           if int(pre_g['fg_index'][0][i]) in pixels(pre_c)]
    rows = [ic[int(pre_g['fg_index'][0][i])] for i in sel]
    sure = [j for j, i in enumerate(sel) if int(pre_g['fg_index'][0][i]) not in ambiguous]
    check(torch.equal(pre_g['classes'][0][sel][sure], pre_c['classes'][0][rows][sure]),
          'classes differ')
    diffs = torch.stack([(cg[i] - cc[j]).abs() for i, j in zip(sel, rows)])
    frac = float((diffs <= 1e-3).all(-1).float().mean())
    print(f'  classes equal (pixels near a tie aside); contours: {100 * frac:.2f}% of points '
          f'within 1e-3 px, mean |diff| '
          f'{float(diffs.mean()):.2e} px, max {float(diffs.max()):.3f} px', flush=True)
    check(frac >= 0.99 and float(diffs.mean()) < 0.1, 'contours differ beyond the gates')


class HeadConvRecorder:
    """Keeps the operands of the first call of each shape that the CPN heads
    make to the head conv kernel (``models.commons.head_conv`` looks up
    ``head_conv_kernel`` at each call) inside the ``with`` block, to hold
    against the plain version afterwards."""

    def __init__(self):
        self.calls = {}

    def __enter__(self):
        def recording(x, weight, bias=None):
            key = (tuple(x.shape), tuple(weight.shape))
            if key not in self.calls:
                self.calls[key] = (x.clone(), weight.clone(),
                                   None if bias is None else bias.clone())
            return head_conv_kernel(x, weight, bias)
        commons.head_conv_kernel = recording
        return self

    def __exit__(self, *exc):
        commons.head_conv_kernel = head_conv_kernel


def hold_head_conv(card, label, x, weight, bias):
    """The head conv kernel against ``head_conv_plain`` on a main path's own
    head inputs, within two halves of a bf16 ulp (both round once, after fp32
    sums in different orders) plus the error bound of fp32 sums of the depth's
    terms, as ``tests/test_torch_port_head_conv.py`` holds it; then its time
    (CUDA events) beside its bound, the plain version and cuDNN's heuristic
    choice for the same bf16 ``F.conv2d`` (``library_ms``, a yardstick the
    port does not call)."""
    bsz, cin, h, w = x.shape
    cout, _, k, _ = weight.shape
    got = head_conv_kernel(x, weight, bias).float()
    want = head_conv_plain(x, weight, bias).float()
    diff = (got - want).abs()
    tol = 2. ** -7 * want.abs() + cin * k * k * 2. ** -23 * want.abs().max()
    worst = float((diff / tol.clamp_min(1e-30)).max())
    check(bool((diff <= tol).all()),
          f'{label}: the head conv kernel and its plain version differ, {worst:.3f} of the bound')
    ops = 2. * bsz * h * w * cout * cin * k * k
    nbytes = 2. * (x.numel() + weight.numel() + bsz * h * w * cout) + 4. * cout
    t_ops, t_bytes = ops / BF16_TENSOR_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    rec = dict(input=[bsz, cin, h, w], weight=[cout, cin, k, k],
               exact_share=float((diff == 0).float().mean()), max_diff_over_tol=worst,
               ms=cuda_ms(lambda: head_conv_kernel(x, weight, bias), 5, warmup=1),
               plain_ms=cuda_ms(lambda: head_conv_plain(x, weight, bias), 2, warmup=1),
               library_ms=cuda_ms(lambda: torch.nn.functional.conv2d(x, weight, bias,
                                                                     padding=k // 2), 2, warmup=1),
               bound_ms=max(t_ops, t_bytes), bound_by='operations' if t_ops >= t_bytes else 'bytes')
    print(f'  [{card}] head_conv {label} {rec["input"]} x {rec["weight"]}: == plain within the '
          f'bound (largest {worst:.3f} of it, {100 * rec["exact_share"]:.1f}% equal); '
          f'{rec["ms"]:.3f} ms on the device (CUDA events), bound {rec["bound_ms"]:.3f} ms '
          f'({rec["bound_by"]}), plain {rec["plain_ms"]:.3f} ms, cuDNN heuristic '
          f'{rec["library_ms"]:.3f} ms', flush=True)
    return rec


def main_path(rng, card, errs, floor, title, build, tame=False,
              runs=(('fp32', None, 1), ('bf16', torch.bfloat16, 4)), score=1., size=TILE):
    """Phases 5, 9, 15 and 19c: the model ``build(compute_dtype=...)`` makes on
    ``size``^2 tiles in each of ``runs`` (name, compute dtype, batch), with
    ``random_weights(tame, score)``."""
    print(f'== {title} on {size}^2 tiles', flush=True)
    torch.backends.cudnn.allow_tf32 = True          # PyTorch's default for fp32 convolutions
    torch.backends.cuda.matmul.allow_tf32 = False   # PyTorch's default for matmuls
    print('  fp32 convolutions in TF32 (cudnn.allow_tf32=True, the PyTorch default)', flush=True)
    configs = []
    sd = None
    for name, dtype, batch in runs:
        m = build(compute_dtype=dtype)
        if sd is None:
            sd = random_weights(m, tame, score)
        m.load_state_dict(sd, strict=True)
        x = torch.from_numpy(rng.rand(batch, size, size, 3).astype(np.float32)).cuda()
        # score threshold from this configuration's own scores: at least
        # 3072 foreground pixels per image, so the NMS sees 2048 valid boxes
        # (with more than two classes the classes are the argmax and the
        # threshold plays no part)
        probs = torch.sigmoid(m.forward_padded(x, nms=False)['dense_scores'].float())
        if m.uncertainty_head:
            probs = probs * certain_half(m, x).view_as(probs)
        configs.append((name, m, x, threshold_above(probs, 3072)))

    LAUNCHES.clear()                   # the main path's run: counts from 0
    library_total = 0
    runs, head_inputs = [], {}
    for name, m, x, thresh in configs:
        before = LAUNCHES.copy()
        span_recorder.reset()
        span_recorder.enable()         # the cpn.head_conv spans count the calls left to cuDNN
        try:
            with HeadConvRecorder() as recorder:
                pre = m.forward_padded(x, score_thresh=thresh, nms=False)
                out = m.forward_padded(x, score_thresh=thresh)
                res = m(x, score_thresh=thresh)           # the user API: ragged per-image results
                torch.cuda.synchronize()
            heads = [r['counts']['kernel'] for r in span_recorder.collect()
                     if r['name'] == 'cpn.head_conv']
        finally:
            span_recorder.disable()
            span_recorder.reset()
        launched = LAUNCHES - before
        runs.append((name, m, x, thresh, pre, out, res,
                     sum(launched[k] for k in LAUNCH_NAMES)))
        # every head of these models has channels that are multiples of 64:
        # in bf16 each head conv takes the kernel, in fp32 none does
        kernel_calls = launched['cdt_head_conv']
        library_calls = heads.count(0)
        library_total += library_calls
        print(f'  {name}: head conv kernel launches {kernel_calls}, calls left to the library '
              f'{library_calls}', flush=True)
        if m.compute_dtype == torch.bfloat16:
            check(kernel_calls > 0 and library_calls == 0,
                  f'{name}: the bf16 heads did not all take the head conv kernel')
            head_inputs.update({(name,) + key: v for key, v in recorder.calls.items()})
        else:
            check(kernel_calls == 0 and library_calls > 0,
                  f'{name}: the fp32 heads launched the head conv kernel')
        # the Mamba scans of an fp32 model take the fused scan kernel, a bf16 one's the torch scan
        scans = launched['cdt_selective_scan']
        fused = m.compute_dtype != torch.bfloat16 and any(
            isinstance(mod, mamba.Mamba) for mod in m.modules())
        print(f'  {name}: selective scan kernel launches {scans}', flush=True)
        check(scans > 0 if fused else scans == 0,
              f'{name}: {scans} selective scan kernel launches, '
              f'expected {"some" if fused else "none"}')
    launches = nms_launches()
    print(f'  kernel launches in the main path run: {launches}', flush=True)
    check(all(n > 0 for n in launches.values()), 'a kernel of the path was never launched')

    kernel_rec = {'head_conv': dict(
        launches=LAUNCHES['cdt_head_conv'], library_calls=library_total,
        shapes=[hold_head_conv(card, f'{key[0]} main path', *operands)
                for key, operands in head_inputs.items()])}
    del head_inputs
    for name, m, x, thresh, pre, out, res, delta in runs:
        batch = x.shape[0]
        n_pre = pre['valid'].sum(1).tolist()
        n_post = out['valid'].sum(1).tolist()
        check(delta > 0, f'{name}: no NMS kernel launched')
        check(all(n == 2048 for n in n_pre), f'{name}: NMS saw {n_pre} valid boxes, not 2048')
        check(all(n >= 1 for n in n_post), f'{name}: no box kept')
        check([len(c) for c in res['contours']] == n_post, f'{name}: ragged results disagree')
        for key in ('contours', 'boxes', 'scores', 'fourier', 'locations'):
            check(bool(torch.isfinite(out[key]).all()), f'{name}: non-finite {key}')
        check(tuple(out['contours'].shape) == (batch, 2048, 32, 2), f'{name}: contour shape')

        # throughput: host clock around forwards that end in reading the results back
        def step():
            o = m.forward_padded(x, score_thresh=thresh)
            return o['boxes'].cpu(), o['scores'].cpu(), o['valid'].cpu()

        for _ in range(2):
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        iters = 10
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / iters
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        profile_step(step, f'[{card}] {name} batch {batch}')

        # the NMS kernels on this run's own inputs, against their plain versions
        t = m.nms_thresh
        _, b, v = sort_by_score(pre['boxes'], nms_weights(m, pre), pre['valid'])
        k, _, slots, _ = hold_each(b, v, t, errs)
        check(torch.equal(k, _nms_sweep(b, v, t)), f'{name}: the sweep and plain differ')
        print(f'  [{card}] {name} batch {batch}: {batch / dt:.3f} tiles/s '
              f'({1e3 * dt:.2f} ms per forward incl. readback), peak memory '
              f'{peak:.2f} GiB, threshold {thresh:.6f}, valid before NMS {n_pre}, after {n_post}, '
              f'NMS kernel launches {delta}', flush=True)
        ms, dev = time_sweep(f'B={batch} N=2048 t={t} ({name} main path)', b, v, k, t, card, floor)
        plain_ms = cuda_ms(lambda: _nms_sweep(b, v, t), 3, warmup=1)
        print(f'  [{card}] plain _nms_sweep B={batch} N=2048 ({name} main path): {plain_ms:.3f} ms',
              flush=True)
        if name == 'bf16':
            nb = -(-v.shape[1] // BLOCK)
            diag = _suppression_counts(b, v, t)[1]
            pairs = _suppression_pairs(b, v, t, 0, nb)
            removed = torch.zeros(batch, nb, dtype=torch.int64, device=b.device)
            keep = torch.empty_like(v)
            plain = {'nms_bits_count': lambda: _suppression_counts(b, v, t),
                     'nms_bits_fill': lambda: _suppression_pairs(b, v, t, 0, nb),
                     'nms_resolve': lambda: _resolve_blocks(v, diag, pairs, removed, keep, 0, nb)}
            bounds = kernel_bounds(b, v, k, pairs, slots)
            for name_k, fn in plain.items():
                ms_k, _ = dev[name_k]
                kernel_rec[name_k] = dict(ms=ms_k, plain_ms=cuda_ms(fn, 2, warmup=1),
                                          bound_ms=bounds[name_k][0], bound_by=bounds[name_k][1])
                print(f'  [{card}] {name_k} B={batch} N=2048 ({name} main path, '
                      f'{"slots" if slots else "packed"} layout): '
                      f'{ms_k:.4f} ms on the device ({EVENTS}), plain '
                      f'{kernel_rec[name_k]["plain_ms"]:.3f} ms, bound '
                      f'{bounds[name_k][0]:.6f} ms ({bounds[name_k][1]})', flush=True)
    return launches, kernel_rec


SCORE_HEAD_OUT = 'core.score_head.block.4'      # the score head's output convolution


# phase 19c's dense gate: per image, the 99th percentile of the score logits'
# |bf16 - fp32| over the fp32 logits' standard deviation. Set between the
# sound runs of scripts/torch_mamba_bf16_hold.py (at most 0.0702 on the H100)
# and its mildest control, every bf16 parameter scaled by 1 + 0.01 n (0.2069
# and up); the mean is printed, not gated, as it also holds the bf16 rounding
# of the rescaled score bias, a shift of every logit alike.
BF16_LOGIT_P99 = 0.12


def trained_like(build, sd, x, train_seed=0):
    """The fp32 model ``build`` makes (TF32 off) with the weights ``sd``
    trained 12 steps first, in fp32 with cuDNN's deterministic algorithms,
    on 8 toy images of 128^2 (seeds ``8 train_seed`` on; the trainer's seed
    ``SEED + train_seed``), as the CPU tests do (random norm statistics make
    a deep residual net chaotic in bf16). Then, as
    ``tests/test_torch_port_zoo.py`` does for a random network, its score
    head is scaled and shifted so that the widest gap of its logits on ``x``
    between ranks ``100 B`` and ``400 B`` falls on logit 16.5, the
    threshold. Returns the model, its state dict and the threshold."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    m32 = build(compute_dtype=None)
    m32.load_state_dict(sd, strict=True)
    toy = [random_geometric_objects(128, 128, num=12, radius=(6, 14), seed=8 * train_seed + i)
           for i in range(8)]
    deterministic, torch.backends.cudnn.deterministic = torch.backends.cudnn.deterministic, True
    try:
        CPNTrainer(m32, optimizer={'Adam': {'lr': 2e-3}}, log_fn=lambda *a: None,
                   seed=SEED + train_seed).fit(
            [(np.repeat(im[..., None], 3, -1).astype(np.float32), lab) for im, lab in toy],
            epochs=6, batch_size=4, max_instances=32, prefetch=1)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    sd = {k: v.detach().clone() for k, v in m32.state_dict().items()}
    batch = x.shape[0]
    logits = m32.forward_padded(x, nms=False)['dense_scores'].float().flatten()
    s_ = torch.sort(logits, descending=True).values.double().cpu().numpy()
    lo, hi = 100 * batch, 400 * batch
    i = lo - 1 + int(np.argmax(s_[lo - 1:hi - 1] - s_[lo:hi]))
    f = 50. / float(logits.double().std())
    w, b = sd[f'{SCORE_HEAD_OUT}.weight'], sd[f'{SCORE_HEAD_OUT}.bias']
    sd[f'{SCORE_HEAD_OUT}.weight'] = w * np.float32(f)
    sd[f'{SCORE_HEAD_OUT}.bias'] = (b - np.float32((s_[i] + s_[i + 1]) / 2)) * np.float32(f) + \
        np.float32(16.5)
    m32.load_state_dict(sd, strict=True)
    return m32, sd, float(1 / (1 + np.exp(-16.5)))


def bf16_hold(m32, m16, x, thresh):
    """``m16`` (bf16) against ``m32`` (fp32) on ``x``, before NMS, under the
    bf16 gates of the CPU tests (``tests/test_torch_port_cpn.py::
    test_cpn_u12_trained_bf16_matches_jax``): per image, the count of
    detections within 8% (at least 2), 92% of the fp32 boxes matched at IoU
    0.8 and their contours within 0.5 px on average; and the dense score
    logits under ``BF16_LOGIT_P99`` (the selected scores themselves
    saturate to 1 at logit 16.5 and above, so they are not compared).
    Returns the failures and a line of the readings."""
    o32 = m32.forward_padded(x, score_thresh=thresh, nms=False)
    o16 = m16.forward_padded(x, score_thresh=thresh, nms=False)
    fails, rows = [], []
    for j in range(x.shape[0]):
        v32, v16 = o32['valid'][j], o16['valid'][j]
        n32, n16 = int(v32.sum()), int(v16.sum())
        iou = box_iou(o32['boxes'][j][v32].float(), o16['boxes'][j][v16].float())
        best, k = iou.max(1) if n16 else (torch.zeros(n32, device=x.device), None)
        matched = best > 0.8
        frac = float(matched.float().mean()) if n32 else 1.
        contour_err = float((o32['contours'][j][v32][matched].float() -
                             o16['contours'][j][v16][k[matched]].float()).abs().mean()) \
            if int(matched.sum()) else 0.
        l32 = o32['dense_scores'][j].float()
        rel = ((o16['dense_scores'][j].float() - l32).abs() / l32.std()).flatten()
        mean, p99 = float(rel.mean()), float(torch.quantile(rel, 0.99))
        rows.append(f'image {j}: fp32 {n32}, bf16 {n16}, matched {frac:.4f}, contour mean |diff| '
                    f'{contour_err:.3f} px, logits |diff| / std mean {mean:.4f} p99 {p99:.4f}')
        if n32 < 20:
            fails.append(f'image {j}: the fp32 run fired on {n32} pixels')
        if abs(n32 - n16) > max(2, int(0.08 * n32)):
            fails.append(f'image {j}: counts {n32} and {n16}')
        if frac < 0.92 or contour_err >= 0.5 or p99 > BF16_LOGIT_P99:
            fails.append(rows[-1])
    return fails, '; '.join(rows)


def bf16_against_fp32(card, build, sd, x, train_seed=0):
    """The model ``build`` makes in bf16 against the same model in fp32 on the
    same inputs ``x``, with the weights ``sd`` made trained-like
    (:func:`trained_like`), under the gates of :func:`bf16_hold`."""
    m32, sd, thresh = trained_like(build, sd, x, train_seed)
    m16 = build(compute_dtype=torch.bfloat16)
    m16.load_state_dict(sd, strict=True)
    fails, line = bf16_hold(m32, m16, x, thresh)
    print(f'  [{card}] bf16 batch {x.shape[0]} against fp32 (TF32 off) on the same inputs, before '
          f'NMS, threshold sigmoid(16.5) in the fp32 logits\' widest gap between ranks '
          f'{100 * x.shape[0]} and {400 * x.shape[0]}: {line}', flush=True)
    check(not fails, 'bf16 against fp32: ' + '; '.join(fails))


def nms_weights(model, out):
    """What the model's NMS ranks by: the scores, or with ``uncertainty_nms``
    the scores times one less the mean box uncertainty."""
    if model.uncertainty_nms and out['box_uncertainties'] is not None:
        return out['scores'] * (1. - out['box_uncertainties'].mean(-1))
    return out['scores']


def certain_half(model, x):
    """Sets the model's ``certainty_thresh`` so that it keeps the more
    certain half of the score map's pixels of ``x`` (the median of each
    run's mean uncertainties), and returns that mask ``[B, h * w]`` in the
    score map's raster order. A forward with threshold 0 and K the map's
    pixel count selects every pixel, so its ``box_uncertainties`` are the
    whole map's."""
    model.certainty_thresh = None
    probe = model.forward_padded(x, nms=False)
    hw = probe['dense_scores'][0, ..., 0].numel()
    full = model.forward_padded(x, score_thresh=0., nms=False, max_detections=hw)
    u = torch.zeros(x.shape[0], hw, device=x.device)
    u.scatter_(1, full['fg_index'], full['box_uncertainties'].mean(-1))
    median = float(u.median())
    model.certainty_thresh = 1. - median
    return u < median


def blob_mosaic(side, block=TILE, num=160, seed=SEED):
    """A blob mosaic in numpy alone, as ``scripts/bench_gigapixel.py:build_mosaic``
    builds one: a block of ``num`` disks of radius 8-22 px (intensity 0.4-0.9
    over a faint noise floor), repeated with an intensity jitter per block
    so that tiles are not bit-equal. ``side`` is a multiple of ``block``."""
    rng = np.random.RandomState(seed)
    base = (rng.rand(block, block) * 0.03).astype(np.float32)
    for _ in range(num):
        r = rng.randint(8, 22)
        cx, cy = rng.randint(r + 1, block - r - 1, 2)
        yy, xx = np.ogrid[-r:r + 1, -r:r + 1]
        disk = xx * xx + yy * yy <= r * r
        win = base[cy - r:cy + r + 1, cx - r:cx + r + 1]
        win[disk] = np.maximum(win[disk], np.float32(0.4 + 0.5 * rng.rand()))
    reps = side // block
    mosaic = np.empty((side, side), np.float32)
    for by in range(reps):
        for bx in range(reps):
            mosaic[by * block:(by + 1) * block, bx * block:(bx + 1) * block] = \
                base * np.float32(0.9 + 0.01 * ((by * reps + bx) % 10))
    return mosaic


def match_detections(a, b):
    """One-to-one match of two tiled results' detections by box IoU above 0.99,
    or None; returns, for each detection of ``a``, its index in ``b``."""
    if len(a['boxes']) != len(b['boxes']) or not len(a['boxes']):
        return None
    iou = box_iou(torch.from_numpy(a['boxes']), torch.from_numpy(b['boxes']))
    best, match = iou.max(1)
    if sorted(match.tolist()) != list(range(len(match))) or not bool((best > 0.99).all()):
        return None
    return match.numpy()


def phase_tiled_card_vs_cpu(rng):
    """Phase 6: TiledInference of full-width CpnU22 (fp32, TF32 off) on a 640^2
    mosaic in 256^2 tiles at stride 192, the card against the CPU."""
    print('== phase 6: tiled inference, CpnU22 (full width, fp32, TF32 off), 640^2 mosaic in '
          '256^2 tiles at stride 192, card vs CPU', flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu_m = models.CpnU22(in_channels=3, device='cpu')
    sd = random_weights(cpu_m)    # phase 4's weights
    cpu_m.load_state_dict(sd, strict=True)
    gpu_m = models.CpnU22(in_channels=3)
    gpu_m.load_state_dict(sd, strict=True)
    image = rng.rand(640, 640, 3).astype(np.float32)
    tiles = torch.from_numpy(tile_image(image, 256, 192)[0])
    with torch.no_grad():
        p_cpu = torch.sigmoid(cpu_m.core(tiles)['scores'])
        p_err = float((torch.sigmoid(gpu_m.core(tiles.cuda())['scores']).cpu() - p_cpu).abs().max())
    thresh, gap = threshold_in_gap(p_cpu.numpy(), 9 * 300, 9 * 1500)
    check(gap > 4 * p_err, f'score gap {gap} too narrow for the card-cpu difference {p_err}')
    kw = dict(tile_size=256, stride=192, batch_size=3)
    t0 = time.perf_counter()
    res_c = TiledInference(cpu_m, **kw)(image, score_thresh=thresh)
    t1 = time.perf_counter()
    tiled_g = TiledInference(gpu_m, **kw)
    res_g = tiled_g(image, score_thresh=thresh)
    print(f'  threshold {thresh:.6f} (gap {gap:.2e}, score diff {p_err:.2e}); CPU run '
          f'{t1 - t0:.1f} s; tiles {res_c["num_tiles"]} / {res_g["num_tiles"]}, kept '
          f'{res_c["num_valid"]} / {res_g["num_valid"]} (cpu / card), overflow '
          f'{res_c["overflow"]} / {res_g["overflow"]}; card NMS passes '
          f'{[(p["name"], p.get("batch"), p.get("m")) for p in tiled_g.stats["nms"]]}', flush=True)
    for key in ('num_tiles', 'num_valid', 'overflow'):
        check(res_c[key] == res_g[key], f'tiled {key} differs: {res_c[key]} and {res_g[key]}')
    check(res_g['num_tiles'] == 9 and res_g['num_valid'] > 0, 'tiled run: tiles or detections')
    match = match_detections(res_c, res_g)
    check(match is not None, 'the kept detections of the card and the CPU differ')
    diffs = np.abs(res_g['contours'][match] - res_c['contours'])
    frac = float((diffs <= 1e-3).all(-1).mean())
    print(f'  same keep set; contours: {100 * frac:.2f}% of points within 1e-3 px, mean |diff| '
          f'{float(diffs.mean()):.2e} px, max {float(diffs.max()):.3f} px', flush=True)
    check(frac >= 0.99 and float(diffs.mean()) < 0.1, 'tiled contours differ beyond the gates')


def chunked_passes(boxes, scores, valid, thresh, chunk, tile, cap):
    """The inputs of ``ops/boxes.py: nms_chunked``'s two sweeps (its chunked
    branch, the same steps), to time and bound each pass alone: ``(b, v,
    keep)`` of the per-chunk pass ``[chunks, chunk]`` and of the cross-chunk
    pass ``[1, M]``."""
    n = len(boxes)
    chunk += (-chunk) % tile
    cap = min(cap or 4 * chunk, n)
    cap += (-cap) % tile
    s = torch.where(valid, scores, -torch.inf)
    order = torch.sort(s, descending=True, stable=True).indices
    order_p = torch.cat([order, order.new_zeros((-n) % chunk)])
    b, sp, v = boxes[order_p], s[order_p], valid[order_p]
    v[n:] = False
    bc, vc = b.view(-1, chunk, 4), v.view(-1, chunk)
    keep = nms_sweep(bc, vc, thresh)
    flat_keep = keep.reshape(-1)
    m = min(int(flat_keep.sum()), cap)
    surv = torch.sort(torch.where(flat_keep, sp, -torch.inf), descending=True,
                      stable=True).indices[:m]
    bs, vs = b[surv][None], flat_keep[surv][None]
    return (bc, vc, keep), (bs, vs, nms_sweep(bs, vs, thresh))


def stage_line(card, label, res, stats, seconds, peak):
    nms_ms = sum(p['ms'] for p in stats['nms'] if 'ms' in p)
    passes = '; '.join(f'{p["name"]} {p["batch"]} x {p["m"]}: {p["ms"]:.3f} ms, '
                       f'{p["launches"]} launches' for p in stats['nms'] if 'ms' in p)
    surv = ', '.join(f'{p["count"]} (cap {p["cap"]})' for p in stats['nms'] if 'count' in p)
    print(f'  [{card}] {label}: {res["num_tiles"]} tiles in {seconds:.3f} s = '
          f'{res["num_tiles"] / seconds:.3f} tiles/s (host clock, tiling, forwards, stitch and '
          f'readback); forwards {stats["forward_ms"]:.1f} ms, capacity retries '
          f'{stats["retry_ms"]:.1f} ms ({stats["retried_tiles"]} tiles), stitch '
          f'{stats["stitch_ms"]:.1f} ms in {stats["attempts"]} attempt(s) (sort and compaction '
          f'{stats["stitch_ms"] - nms_ms:.1f} ms, NMS {nms_ms:.1f} ms: {passes}), readback '
          f'{stats["readback_ms"]:.1f} ms; valid survivors of the chunks: {surv or "none"}; '
          f'detections {len(res["boxes"])} (num_valid {res["num_valid"]}), overflow '
          f'{res["overflow"]}; peak memory {peak:.2f} GiB', flush=True)


def phase_gigapixel(card, floor):
    """Phase 7: the gigapixel path, TiledInference of full-width CpnU22 on blob
    mosaics of 8192^2 and 16,384^2, with the stitch's NMS held against its
    plain version and each of its passes timed alone."""
    print('== phase 7: gigapixel tiled inference, CpnU22 (full width, spread heads), tile '
          '1024, stride 768, max_outputs 400,000', flush=True)
    torch.backends.cudnn.allow_tf32 = True          # PyTorch's default for fp32 convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    mosaic16 = blob_mosaic(16384)
    mosaic8 = np.ascontiguousarray(mosaic16[:8192, :8192])
    print(f'  blob mosaics 16,384^2 and 8192^2 built in {time.perf_counter() - t0:.1f} s', flush=True)
    kw = dict(in_channels=1, max_detections=2048, samples=32)
    fp32 = models.CpnU22(**kw)
    # spread heads. scripts/bench_gigapixel.py multiplies the JAX package's
    # output layers by 300 (score) and 25 (Fourier); this init's fields are
    # far wider already, and those factors saturate the sigmoid and give
    # contours of some 250 px. These factors give a 256^2 crop of the mosaic
    # unsaturated scores and 8-px boxes, of which its NMS keeps 26%, about the
    # share of its candidates that the JAX package's 16,384^2 run kept
    # (236,877 of 441 x 2000).
    sd = random_weights(fp32, score=0.25, fourier=0.1)
    fp32.load_state_dict(sd, strict=True)
    bf16 = models.CpnU22(compute_dtype=torch.bfloat16, **kw)
    bf16.load_state_dict(sd, strict=True)
    tiled = {name: TiledInference(m, tile_size=TILE, stride=768, batch_size=batch,
                                  max_outputs=400_000)
             for name, m, batch in (('bf16', bf16, 4), ('fp32', fp32, 1))}
    # per compute type, the threshold that leaves at most 2000 foreground
    # pixels in every tile of the 8192^2 mosaic (exactly 2000 in one): no tile
    # overflows the capacity of 2048 there, so its stitch sweeps 121 x 2048 rows
    tiles8 = tile_image(mosaic8, TILE, 768)[0]
    thresh = {}
    for name, t in tiled.items():
        highest = []
        for i in range(0, len(tiles8), 4):
            x = torch.from_numpy(tiles8[i:i + 4]).cuda()
            p = torch.sigmoid(t.model.forward_padded(x, nms=False)['dense_scores'].float())
            highest.append(torch.topk(p.flatten(1), 2001, dim=1).values[:, -1])
        thresh[name] = float(torch.cat(highest).max())
        t(mosaic16[:2 * TILE, :2 * TILE], score_thresh=thresh[name])   # warm-up
    torch.cuda.synchronize()
    del tiles8
    print(f'  thresholds {thresh} (at most 2000 foreground pixels in every 8192^2 tile)',
          flush=True)
    check(all(0 < t < 1 for t in thresh.values()), f'thresholds out of range: {thresh}')

    LAUNCHES.clear()                   # the tiled path's run: counts from 0
    runs = {}
    for label, name, mosaic in (('8192^2 bf16 batch 4', 'bf16', mosaic8),
                                ('8192^2 fp32 batch 1 (TF32 convolutions)', 'fp32', mosaic8),
                                ('16384^2 bf16 batch 4', 'bf16', mosaic16)):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = tiled[name](mosaic, score_thresh=thresh[name])
        seconds = time.perf_counter() - t0
        stats = dict(tiled[name].stats)
        stage_line(card, label, res, stats, seconds, torch.cuda.max_memory_allocated() / 2 ** 30)
        check(res['num_valid'] == len(res['boxes']) > 0, f'{label}: no detections')
        check(res['contours'].shape[1:] == (32, 2) and all(
            np.isfinite(res[k]).all() for k in ('contours', 'boxes', 'scores', 'fourier',
                                                'locations')), f'{label}: bad results')
        runs[label] = res, stats
    launches = nms_launches()
    print(f'  kernel launches in the tiled path run: {launches}', flush=True)
    check(all(n > 0 for n in launches.values()), 'a kernel of the tiled path was never launched')
    # the user's entry point: model(image) above max_imsize (2048) tiles itself
    # (tile 1024, stride 512) and gives the JAX package's schema in global coordinates
    image = mosaic8[:2560, :2560, None]
    model = tiled['fp32'].model
    t0 = time.perf_counter()
    out = model(image, score_thresh=thresh['fp32'])
    seconds = time.perf_counter() - t0
    ref = TiledInference(model, tile_size=TILE, stride=512)(image, score_thresh=thresh['fp32'])
    boxes = out['boxes'][0] if len(out['boxes']) == 1 else np.zeros((0, 4))
    print(f'  [{card}] model(image) on 2560^2 (max_imsize 2048): {out["num_tiles"]} tiles in '
          f'{seconds:.3f} s, {len(boxes)} detections (TiledInference: {ref["num_valid"]}), '
          f'boxes up to x {float(boxes[:, 2].max()) if len(boxes) else 0.:.1f}, '
          f'fg_overflow {out["fg_overflow"]}', flush=True)
    check(out['num_tiles'] == ref['num_tiles'] == 16 and len(out['contours']) == 1
          and len(boxes) == ref['num_valid'] > 0 and float(boxes[:, 2].max()) > TILE
          and np.isfinite(out['contours'][0]).all(), 'model(image) above max_imsize')
    res16, stats16 = runs['16384^2 bf16 batch 4']
    check(res16['num_tiles'] == 441 and not res16['overflow'], '16384^2: tiles or overflow')
    for label in ('8192^2 bf16 batch 4', '8192^2 fp32 batch 1 (TF32 convolutions)'):
        check(runs[label][0]['num_tiles'] == 121 and runs[label][1]['retried_tiles'] == 0
              and [p['name'] for p in runs[label][1]['nms']] == ['exact'],
              f'{label}: not 121 tiles in one exact pass')
    surv = [p for p in stats16['nms'] if 'count' in p]
    check(len(surv) > 0, '16384^2: the stitch did not take the chunked NMS')

    # the stitch's NMS on the same candidates against its plain version, and
    # each of its passes alone, timed beside its bound
    t = tiled['bf16'].model.nms_thresh
    chunk, tile = tiled['bf16'].nms_chunk, tiled['bf16'].nms_tile
    for label, mosaic, cap in (('8192^2', mosaic8, None), ('16384^2', mosaic16, surv[-1]['cap'])):
        flat, _, _ = tiled['bf16'].candidates(mosaic, thresh['bf16'])
        boxes, scores, valid = flat['boxes'], flat['scores'], flat['valid']
        traces = [], []
        keep = nms_chunked(boxes, scores, valid, t, chunk, tile, cap, trace=traces[0])
        plain = nms_chunked(boxes, scores, valid, t, chunk, tile, cap, trace=traces[1],
                            sweep=_nms_sweep)
        check(torch.equal(keep, plain), f'{label}: the stitch NMS and its plain version differ')
        for p, q in zip(*traces):
            if 'ms' in p:
                print(f'  [{card}] stitch NMS {label} {p["name"]} {p["batch"]} x {p["m"]} '
                      f'({"large" if large_layout(p["m"]) else "packed"} layout): '
                      f'{p["ms"]:.3f} ms, plain {q["ms"]:.3f} ms, {p["launches"]} launches; '
                      f'keep == plain', flush=True)
            else:
                print(f'  stitch NMS {label}: {p["count"]} valid survivors of the chunks, cap '
                      f'{p["cap"]}', flush=True)
        print(f'  stitch NMS {label}: {len(boxes)} candidate rows, {int(valid.sum())} valid, '
              f'{int(keep.sum())} kept, keep mask == plain version', flush=True)
        if len(boxes) > 262_144:
            (bc, vc, kc), (bs, vs, ks) = chunked_passes(boxes, scores, valid, t, chunk, tile, cap)
            time_sweep(f'stitch {label} per-chunk pass', bc, vc, kc, t, card, floor)
            time_sweep(f'stitch {label} cross-chunk pass', bs, vs, ks, t, card, floor)
            for p in surv[:-1]:    # the cross-chunk passes of the earlier attempts, at their caps
                _, (bs, vs, ks) = chunked_passes(boxes, scores, valid, t, chunk, tile, p['cap'])
                time_sweep(f'stitch {label} cross-chunk pass at cap {p["cap"]}', bs, vs, ks, t,
                           card, floor)
                plain_ms = cuda_ms(lambda: _nms_sweep(bs, vs, t), 1, warmup=0)
                print(f'  [{card}] plain _nms_sweep stitch {label} cross-chunk pass 1 x '
                      f'{vs.shape[1]} (cap {p["cap"]}): {plain_ms:.3f} ms', flush=True)
        else:
            _, b, v = sort_by_score(boxes[None], scores[None], valid[None])
            time_sweep(f'stitch {label} exact pass', b, v, nms_sweep(b, v, t), t, card, floor)
        del flat, boxes, scores, valid
    fp32_run = runs['8192^2 fp32 batch 1 (TF32 convolutions)'][0]
    return launches, dict(inputs=dict(tiles_state=sd, tiles_thresh=thresh['fp32'], mosaic8=mosaic8),
                          tiles_result=fp32_run)


def phase_tiled_flagship(card):
    """Phase 10: TiledInference of the flagship (bf16, batch 4) on a 2048^2
    blob mosaic, tile 1024, stride 768."""
    print('== phase 10: tiled inference, CpnResNeXt101UNet (full width and depth, bf16, batch '
          '4), 2048^2 blob mosaic, tile 1024, stride 768', flush=True)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    mosaic, stride = blob_mosaic(2 * TILE, TILE), 3 * TILE // 4
    m = models.CpnResNeXt101UNet(in_channels=1, compute_dtype=torch.bfloat16, **FLAGSHIP)
    # phase 7's spread of the Fourier head, for boxes of cell size
    m.load_state_dict(random_weights(m, tame=True, fourier=0.1), strict=True)
    tiled = TiledInference(m, tile_size=TILE, stride=stride, batch_size=4)
    tiles = torch.from_numpy(tile_image(mosaic, TILE, stride)[0]).cuda()
    # at most 2000 foreground pixels in every tile, so no tile is retried
    highest = [torch.topk(torch.sigmoid(m.forward_padded(tiles[i:i + 4], nms=False)[
        'dense_scores'].float()).flatten(1), 2001, dim=1).values[:, -1]
        for i in range(0, len(tiles), 4)]
    thresh = float(torch.cat(highest).max())
    del tiles
    check(0 < thresh < 1, f'threshold out of range: {thresh}')
    tiled(mosaic, score_thresh=thresh)            # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = tiled(mosaic, score_thresh=thresh)
    seconds = time.perf_counter() - t0
    stage_line(card, f'2048^2 bf16 batch 4, threshold {thresh:.6f}', res, dict(tiled.stats),
               seconds, torch.cuda.max_memory_allocated() / 2 ** 30)
    check(res['num_tiles'] == 9 and res['num_valid'] == len(res['boxes']) > 0
          and not res['overflow'], '2048^2: tiles, detections or overflow')
    check(res['contours'].shape[1:] == (32, 2) and all(
        np.isfinite(res[k]).all() for k in ('contours', 'boxes', 'scores', 'fourier',
                                            'locations')), '2048^2: bad results')


def disk_images(n, size, seed, num=24, radius=(6, 14)):
    """``n`` training pairs ``(image [size, size, 1], labels [size, size, 1])``
    drawn with numpy (phase 11b's workload since before the port had
    ``data.random_geometric_objects``, which phase 19a uses): up to ``num`` non-overlapping disks of
    radius ``radius`` (a disk that would overlap one already placed is left
    out), intensity 0.4-0.9, noise 0.03."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:size, :size]
    out = []
    for _ in range(n):
        labels = np.zeros((size, size, 1), np.int32)
        image = np.zeros((size, size), np.float32)
        for _ in range(num):
            r = rng.randint(*radius)
            cx, cy = rng.randint(r + 1, size - r - 1, 2)
            disk = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
            if (labels[disk] > 0).any():
                continue
            labels[disk, 0] = labels.max() + 1
            image[disk] = 0.4 + 0.5 * rng.rand()
        image += rng.randn(size, size).astype(np.float32) * 0.03
        out.append((np.clip(image, 0, 1)[..., None], labels))
    return out


def train_batch(pairs, samples, seed):
    """Targets of ``pairs`` from the port's numpy pipeline, as one batch."""
    items = [cpn_targets_single(lab, samples, 5, rng=np.random.RandomState(seed + i))
             for i, (_, lab) in enumerate(pairs)]
    targets = collate_cpn_targets(items, max_instances=128)
    targets.pop('num_instances')
    return {'image': np.stack([im for im, _ in pairs]), **targets}


def biases_before_norms(model):
    """Conv biases that feed a batch norm: in train mode their gradient is 0
    but for rounding (the norm subtracts the batch mean)."""
    keys = set()
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.Sequential):
            for i in range(len(mod) - 1):
                if isinstance(mod[i], torch.nn.Conv2d) and isinstance(mod[i + 1], models.Norm):
                    keys.add(f'{name}.{i}.bias')
    return keys


def train_step_on(dev, dtype, batch_np, sd, refinement_iterations):
    """One ``make_train_step`` step of full-width CpnU22 (weights ``sd``,
    dropout off) on ``dev`` in ``dtype``: loss terms, gradients and running
    statistics (float64, on the CPU), seconds, and the biases before norms."""
    size = batch_np['image'].shape[1]
    m = models.CpnU22(in_channels=1, samples=32, max_detections=(size // 2) ** 2,
                      refinement_iterations=refinement_iterations, device=dev)
    m.load_state_dict(sd, strict=True)
    m.to(dtype)
    for d in m._dropouts:          # the devices' generators differ: no dropout here
        d.p = 0.
    if dtype == torch.float64:
        batch_np = {k: v.astype(np.float64) if v.dtype == np.float32 else v
                    for k, v in batch_np.items()}
    state = TrainState.create(m, conf2optimizer({'Adam': {'lr': 5e-4}}))
    t0 = time.perf_counter()
    _, metrics = make_train_step(m, state.optimizer)(
        state, batch_np, torch.Generator(device=dev).manual_seed(SEED))
    loss = {k: float(v) for k, v in metrics.items()}
    sec = time.perf_counter() - t0
    grads = {k: p.grad.detach().cpu().double() for k, p in m.named_parameters()
             if p.grad is not None}
    stats = {k: v.detach().cpu().double() for k, v in m.named_buffers()}
    return loss, grads, stats, sec, biases_before_norms(m)


def gradient_errors(g64, grads, zero):
    """Per tensor, max |grads - g64| in units of the tensor's largest |g64|
    (a conv bias before a norm: its weight's, its own being 0 but for rounding)."""
    out = {}
    for k, g in g64.items():
        scale = max(float(g64[k[:-len('bias')] + 'weight' if k in zero else k].abs().max()), 1e-30)
        out[k] = float((grads[k] - g).abs().max()) / scale
    return out


def phase_train_card_vs_cpu():
    """Phase 11a: one training step of full-width CpnU22 on the card and on
    the CPU, TF32 off, the same weights and batch, in float32 and float64."""
    size, batch, loops = 128, 2, 4
    print(f'== phase 11a: one training step, CpnU22 (full width, one channel, {loops} refinement '
          f'loops) at {size}^2, batch {batch}, K {(size // 2) ** 2}, card vs CPU, TF32 off',
          flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch_np = train_batch(disk_images(batch, size, SEED + 11), 32, SEED)
    sd = random_weights(models.CpnU22(in_channels=1, samples=32, device='cpu'))
    runs = {name: train_step_on(dev, dt, batch_np, sd, loops) for name, dev, dt in (
        ('cpu', 'cpu', torch.float32), ('card', 'cuda', torch.float32),
        ('cpu64', 'cpu', torch.float64), ('card64', 'cuda', torch.float64))}
    (lc, gc, sc, cpu_s, zero), (lg, gg, sg, gpu_s, _) = runs['cpu'], runs['card']
    g64, gg64 = runs['cpu64'][1], runs['card64'][1]
    print(f'  step on the CPU {cpu_s:.1f} s (float64 {runs["cpu64"][3]:.1f} s), card '
          f'{gpu_s:.2f} s (float64 {runs["card64"][3]:.2f} s; first calls, cuDNN set-up '
          f'included)', flush=True)
    check(set(lc) == set(lg), 'loss terms differ')
    rel = {k: abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-30) for k in lc}
    worst = max(rel, key=rel.get)
    print(f'  float32 loss card {lg["loss"]:.6f}, cpu {lc["loss"]:.6f}; worst term {worst}: '
          f'relative {rel[worst]:.2e} (gate 1e-4)', flush=True)
    check(rel[worst] <= 1e-4, f'loss term {worst} differs by {rel[worst]:.2e}')
    check(all(bool(torch.isfinite(g).all()) for g in gg.values()), 'a card gradient is not finite')
    serr = {k: float((sg[k] - v).abs().max()) / max(1., float(v.abs().max()))
            for k, v in sc.items()}
    worst = max(serr, key=serr.get)
    print(f'  float32 running statistics: worst {worst}: {serr[worst]:.2e} (gate 1e-5 of '
          f'max(1, |value|))', flush=True)
    check(serr[worst] <= 1e-5, f'running statistic {worst} differs by {serr[worst]:.2e}')
    # The gradients are held in float64: random full-width weights leave some
    # of them ill-conditioned in float32 (the train-mode norms remove most of
    # what reaches the deep layers), so that float32 on either device lies up
    # to some 7e-2 of a tensor's largest gradient from float64. In float64 the
    # card and the CPU compute the same function to rounding.
    e64 = gradient_errors(g64, gg64, zero)
    worst = max(e64, key=e64.get)
    print(f'  float64 gradients, card vs CPU: worst {worst}: {e64[worst]:.2e} of the largest '
          f'|gradient| (gate 1e-8; a conv bias before a norm against its weight\'s)', flush=True)
    check(e64[worst] <= 1e-8, f'float64 gradient {worst} differs by {e64[worst]:.2e}')
    e_card, e_cpu = gradient_errors(g64, gg, zero), gradient_errors(g64, gc, zero)
    e_pair = gradient_errors(gc, gg, zero)
    worst = max(e_card, key=e_card.get)
    n_card, n_cpu, n_pair = (sum(e <= 1e-3 for e in d.values()) for d in (e_card, e_cpu, e_pair))
    print(f'  float32 gradients against float64, within 1e-3: card {n_card}, CPU {n_cpu} of '
          f'{len(e_card)} tensors; card vs CPU within 1e-3: {n_pair}; worst on the card '
          f'{worst}: {e_card[worst]:.2e} (CPU {e_cpu[worst]:.2e})', flush=True)


def reset_launches():
    LAUNCHES.clear()


def read_launches():
    torch.cuda.synchronize()
    return nms_launches()


def phase_train(card, errs, floor):
    """Phases 11b and 11c: ``CPNTrainer.fit`` on scripts/bench_train.py's
    workload, then 30 steps on one batch and ``CPNTrainer.predict`` (its NMS
    call held and timed).
    Returns the NMS kernels' launches in ``predict``, the trainer and the
    images of its fixed batch."""
    print(f'== phase 11b: training, CpnU22 (full width, one channel), {TRAIN_SIZE}^2, batch '
          f'{TRAIN_BATCH}, samples {TRAIN["samples"]}, K {TRAIN["max_detections"]}, Adam 5e-4, '
          f'prefetch 1, {TRAIN_IMAGES} images of 24 disks (scripts/bench_train.py)', flush=True)
    torch.backends.cudnn.allow_tf32 = True          # PyTorch's default for fp32 convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    data = disk_images(TRAIN_IMAGES, TRAIN_SIZE, SEED)
    model = models.CpnU22(in_channels=1, **TRAIN)
    model.load_state_dict(random_weights(model), strict=True)
    trainer = CPNTrainer(model, optimizer={'Adam': {'lr': 5e-4}}, log_fn=lambda *a: None,
                         seed=SEED)
    fit = dict(batch_size=TRAIN_BATCH, crop_size=TRAIN_SIZE, prefetch=1)
    t0 = time.perf_counter()
    trainer.fit(data, epochs=1, **fit)                 # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    epochs = 3
    t0 = time.perf_counter()
    hist = trainer.fit(data, epochs=epochs, **fit)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_imgs = epochs * (-(-TRAIN_IMAGES // TRAIN_BATCH)) * TRAIN_BATCH
    check(len(hist) == 4 and all(np.isfinite(h['loss']) for h in hist), 'fit: bad history')

    batches = []                                       # the host's part alone
    t0 = time.perf_counter()
    for j in range(4):
        batches.append(trainer._make_batch(data, np.arange(TRAIN_BATCH) + TRAIN_BATCH * j,
                                           TRAIN['samples'], 5, 128, np.random.RandomState(j),
                                           crop_size=TRAIN_SIZE))
    host_ms = (time.perf_counter() - t0) / 4 * 1e3
    step, state, gen = trainer._step_fn, trainer.state, trainer.generator
    batch = batches[0]
    for _ in range(2):
        step(state, batch, gen)
    torch.cuda.synchronize()
    iters = 20
    t0 = time.perf_counter()
    for _ in range(iters):
        step(state, batch, gen)
    torch.cuda.synchronize()
    dev_s = (time.perf_counter() - t0) / iters
    dev_rate = TRAIN_BATCH / dev_s
    idle = max(0., 1. - (n_imgs / dev_rate) / wall)
    print(f'  [{card}] end to end {n_imgs / wall:.3f} imgs/s ({epochs} epochs, {n_imgs} images '
          f'in {wall:.3f} s; warm-up epoch {warm_s:.1f} s); device alone {dev_rate:.3f} imgs/s '
          f'({1e3 * dev_s:.2f} ms a step of {TRAIN_BATCH}); host targets {host_ms:.1f} ms a batch; '
          f'device idle share {idle:.4f}; peak memory {peak:.2f} GiB; losses by epoch '
          f'{[round(h["loss"], 3) for h in hist]}', flush=True)
    profile_step(lambda: step(state, batch, gen), f'[{card}] training step, batch {TRAIN_BATCH}',
                 top=10)

    print('== phase 11c: 30 steps on one fixed batch, then CPNTrainer.predict on two held-out '
          f'{TRAIN_SIZE}^2 images', flush=True)
    losses = [float(step(state, batches[1], gen)[1]['loss']) for _ in range(30)]
    print(f'  loss {losses[0]:.4f} -> {losses[-1]:.4f} (last / first {losses[-1] / losses[0]:.4f})',
          flush=True)
    check(losses[-1] < losses[0], 'the loss did not fall on a fixed batch')
    held = [im for im, _ in disk_images(2, TRAIN_SIZE, SEED + 99)]
    reset_launches()
    preds = trainer.predict(held)
    launches = read_launches()
    print(f'  predict: {[len(p["contours"]) for p in preds]} detections; NMS kernel launches '
          f'{launches}', flush=True)
    check(all(n > 0 for n in launches.values()), 'predict launched no NMS kernel')
    for p in preds:
        check(p['contours'].shape[1:] == (TRAIN['samples'], 2) and all(
            np.isfinite(p[k]).all() for k in ('contours', 'boxes', 'scores')), 'predict: bad results')
    time_forward_nms('a predict forward', trainer.model, trainer.model.prepare_inputs(held[0]),
                     errs, card, floor)
    # batches[1], the fixed batch, holds items 8-15
    return launches, trainer, data[TRAIN_BATCH:2 * TRAIN_BATCH]


def phase_checkpoints(rng, card, trainer, fixed, ckpt):
    """Phase 12: checkpoint I/O on the card. The trained fixture from its cdt
    file on the card against the CPU; the flagship saved and loaded (state
    dicts and forwards bit-equal); phase 11c's trainer saved to ``ckpt`` and
    loaded into a new trainer, and one more epoch from both (losses
    bit-equal)."""
    fixture = os.path.join(HERE, 'tests', 'fixtures', 'cpnu12_trained.cdt')
    image = disk_images(1, CHECK_SIZE, SEED + 5)[0][0][None]
    # K above the score map's pixels above the threshold: no capacity cut
    phase_card_vs_cpu(rng, 'phase 12a: the trained CpnU12 of tests/fixtures/cpnu12_trained.cdt '
                      '(load_model, K 4096)',
                      lambda **kw: load_model(fixture, max_detections=4096, **kw),
                      image=image, counts=(100, 3000))

    print('== phase 12b: the flagship CpnResNeXt101UNet (full width and depth) saved and loaded '
          'on the card (cdt file)', flush=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    model = models.CpnResNeXt101UNet(in_channels=3, **FLAGSHIP)
    model.load_state_dict(random_weights(model, tame=True), strict=True)
    with tempfile.TemporaryDirectory() as tmp:
        fn = os.path.join(tmp, 'flagship.cdt')
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_model(fn, model, meta={'purpose': 'chip_smoke phase 12'})
        save_s = time.perf_counter() - t0
        mib = os.path.getsize(fn) / 2 ** 20
        t0 = time.perf_counter()
        loaded = load_model(fn)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        check(load_model_meta(fn)['purpose'] == 'chip_smoke phase 12', 'file meta lost')
    want, got = model.state_dict(), loaded.state_dict()
    check(sorted(want) == sorted(got) and all(torch.equal(want[k], got[k]) for k in want),
          'the loaded flagship differs from the saved one')
    check(loaded.device.type == 'cuda' and loaded.samples == FLAGSHIP['samples'] and
          loaded.nms_thresh == FLAGSHIP['nms_thresh'], 'the loaded flagship lost its settings')
    x = torch.rand(1, CHECK_SIZE, CHECK_SIZE, 3, generator=torch.Generator().manual_seed(SEED))
    outs = [m.forward_padded(x.cuda(), score_thresh=0.5) for m in (model, loaded)]
    same = all(torch.equal(outs[0][k], outs[1][k]) for k in ('scores', 'boxes', 'contours',
                                                             'valid', 'fourier'))
    check(same, 'the loaded flagship\'s forward differs')
    print(f'  [{card}] {len(want)} tensors, {sum(t.numel() for t in want.values())} values: '
          f'file {mib:.1f} MiB, save_model {save_s:.2f} s, load_model onto the card '
          f'{load_s:.2f} s; state dict and forward ({int(outs[0]["valid"].sum())} detections at '
          f'{CHECK_SIZE}^2) bit-equal', flush=True)
    del model, loaded, outs

    print('== phase 12c: phase 11c\'s trainer saved, loaded into a new CPNTrainer, one more '
          'epoch from both', flush=True)
    t0 = time.perf_counter()
    trainer.save_checkpoint(ckpt)
    save_s = time.perf_counter() - t0
    resumed = CPNTrainer(models.CpnU22(in_channels=1, **TRAIN),
                         optimizer={'Adam': {'lr': 5e-4}}, log_fn=lambda *a: None, seed=SEED)
    t0 = time.perf_counter()
    resumed.load_checkpoint(ckpt)
    load_s = time.perf_counter() - t0
    check(resumed.state.step == trainer.state.step, 'the step was not restored')
    fit = dict(epochs=1, batch_size=TRAIN_BATCH, crop_size=TRAIN_SIZE, prefetch=1)
    losses = [t.fit(fixed, **fit)[-1]['loss'] for t in (trainer, resumed)]
    print(f'  [{card}] checkpoint {os.path.getsize(ckpt) / 2 ** 20:.1f} MiB, saved in {save_s:.2f} '
          f's, loaded in {load_s:.2f} s; step {resumed.state.step - 1} -> {resumed.state.step}; '
          f'loss of the next epoch: original {losses[0]!r}, resumed {losses[1]!r} '
          f'(cudnn.deterministic)', flush=True)
    check(losses[0] == losses[1], 'the resumed run\'s loss differs')
    torch.backends.cudnn.deterministic = False
    absent = {'msgpack', 'flax', 'h5py'} & set(sys.modules)
    check(not absent, f'{sorted(absent)} imported')
    print('  msgpack, flax and h5py were not imported', flush=True)


def summed_counts(result, iou_index=0):
    """TP, FP and FN summed over the images, at one IoU threshold."""
    return tuple(int(v) for v in result['counts'][:, iou_index].sum(0))


def phase_validate(card, fixed, ckpt, errs, floor):
    """Phase 13: ``CPNTrainer.fit(val_data=)`` and ``validate`` of full-width
    CpnU22 with phase 11c's weights on 4 held-out 512^2 images, the card
    against the CPU; the NMS call of one validation forward held against its
    plain version and timed. Returns the NMS kernels' launches in one
    ``validate``."""
    hparams = {'score_thresh': [.5, .7, .9], 'nms_thresh': [.2, .5]}
    settings = len(hparams['score_thresh']) * len(hparams['nms_thresh'])
    val = disk_images(4, 512, SEED + 13, num=48)
    print(f'== phase 13: validation, CpnU22 (full width, one channel, phase 11c\'s weights), '
          f'{len(val)} held-out 512^2 images, sweep {hparams}', flush=True)
    torch.backends.cudnn.allow_tf32 = True
    trainer = CPNTrainer(models.CpnU22(in_channels=1, **TRAIN), optimizer={'Adam': {'lr': 5e-4}},
                         val_hparams=hparams, log_fn=lambda *a: None, seed=SEED)
    trainer.load_checkpoint(ckpt)
    reset_launches()
    t0 = time.perf_counter()
    trainer.fit(fixed, epochs=1, batch_size=TRAIN_BATCH, crop_size=TRAIN_SIZE, val_data=val,
                val_every=1)
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    print(f'  fit(val_data=, val_every=1): one step and one validate in {fit_s:.2f} s; best '
          f'{trainer.best_hparams}; NMS kernel launches {launches}', flush=True)
    check(all(n == settings * len(val) for n in launches.values()),
          f'fit(val_data=) launched {launches}, not {settings * len(val)} of each kernel')
    check(all(getattr(trainer.model, k) == v for k, v in trainer.best_hparams.items()),
          'fit did not calibrate the model')

    # the native fill of fast_labels, built with g++ before the timed runs; a
    # failed build fails here (validate itself would fall back to the render)
    t0 = time.perf_counter()
    rasterize_library()
    build_s = time.perf_counter() - t0
    pred = trainer._predict_single(val[0][0])
    flat = contours2labels_native(list(pred['contours']), val[0][1].shape[:2], fallback=False)
    ref = contours2labels(list(pred['contours']), flat.shape).max(-1) > 0
    union = int((ref | (flat > 0)).sum())
    overlap = int((ref & (flat > 0)).sum()) / max(union, 1)
    check(flat.dtype == np.int32 and flat.max() <= len(pred['contours']) and
          (union == 0 or overlap >= 0.5), f'native fill: bad labels (overlap {overlap})')
    print(f'  native rasterizer (celldetection_tpu_torch/native/rasterize.cpp) built and loaded in '
          f'{build_s:.2f} s; its foreground on one image against the channelled render: IoU '
          f'{overlap:.4f}', flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    for fast in (False, True):
        reset_launches()
        t0 = time.perf_counter()
        out = trainer.validate(val, fast_labels=fast)
        wall = time.perf_counter() - t0
        runs[fast] = (out, [dict(r) for r in trainer.val_results], dict(trainer.val_seconds),
                      read_launches())
        sec = trainer.val_seconds
        n = settings * len(val)
        print(f'  [{card}] validate(fast_labels={fast}) (TF32 off): {wall:.2f} s for {settings} '
              f'settings x {len(val)} images; per image and setting {1e3 * wall / n:.1f} ms: '
              f'forward on the card with readback {1e3 * sec["forward"] / n:.1f} ms, host labels '
              f'{1e3 * sec["labels"] / n:.1f} ms, host matching {1e3 * sec["matching"] / n:.1f} '
              f'ms; best {out["best_hparams"]} (f1_np {out["f1_np"]:.4f}); NMS kernel launches '
              f'{runs[fast][3]}', flush=True)
        for r in runs[fast][1]:
            print(f'    {r["setting"]}: f1_np {r["metrics"]["f1_np"]:.4f}, TP/FP/FN at IoU 0.5 '
                  f'{summed_counts(r)}', flush=True)
        check(all(n == settings * len(val) for n in runs[fast][3].values()),
              f'validate launched {runs[fast][3]}, not {settings * len(val)} of each kernel')
        check(all(getattr(trainer.model, k) == v for k, v in out['best_hparams'].items()),
              'validate did not calibrate the model')
        for r in runs[fast][1]:
            check(np.isfinite(r['metrics']['f1_np']), 'validate: f1_np not finite')

    # the NMS of one validation forward (the calibrated setting, first image)
    time_forward_nms('a validation forward', trainer.model,
                     torch.from_numpy(val[0][0][None]).cuda(), errs, card, floor)

    cpu_model = models.CpnU22(in_channels=1, device='cpu', **TRAIN)
    cpu_model.load_state_dict({k: v.cpu() for k, v in trainer.model.state_dict().items()})
    cpu = CPNTrainer(cpu_model, val_hparams=hparams, log_fn=lambda *a: None, seed=SEED)
    t0 = time.perf_counter()
    cpu_out = cpu.validate(val)
    cpu_s = time.perf_counter() - t0
    card_out, card_results = runs[False][0], runs[False][1]
    worst = 0
    for rc, rg in zip(cpu.val_results, card_results):
        check(rc['setting'] == rg['setting'], 'the sweeps differ')
        diff = np.abs(rc['counts'] - rg['counts'])
        worst = max(worst, int(diff.max()))
        for i in sorted(set(np.nonzero(diff)[0].tolist())):
            pc = cpu._predict_single(val[i][0], **rc['setting'])
            pg = trainer._predict_single(val[i][0], **rg['setting'])
            print(f'    {rc["setting"]} image {i}: TP/FP/FN by IoU cpu '
                  f'{rc["counts"][i].tolist()}, card {rg["counts"][i].tolist()}; detections cpu '
                  f'{len(pc["contours"])}, card {len(pg["contours"])}; reason: scores and '
                  f'contour points near a threshold (max |score| diff '
                  f'{score_gap(pc, pg):.2e})', flush=True)
    print(f'  CPU validate {cpu_s:.1f} s ({torch.get_num_threads()} threads); best cpu {cpu_out["best_hparams"]}, card '
          f'{card_out["best_hparams"]}; largest count difference per image {worst}', flush=True)
    check(worst <= 1, f'card and CPU counts differ by {worst} instances in an image')
    check(cpu_out['best_hparams'] == card_out['best_hparams'], 'best_hparams differ')
    ref = dict(inputs=dict(val_state={k: v.cpu() for k, v in trainer.model.state_dict().items()},
                           val_hparams=hparams, val_data=val),
               val_results=card_results, val_best=card_out['best_hparams'])
    return runs[False][3], ref


# phase 14: each new family at full width and depth (as the JAX package builds
# them), with random_weights' ``score`` and ``fourier`` factors beside its
# tame 0.25 on the score head where these random weights put logits of 60-95
# (ConvNeXtV2, DenseNet, ResUNet: the sigmoid saturates and leaves no gap for
# a threshold) and Fourier coefficients of 60-230 (outlines across the whole
# tile, of which NMS keeps one), and the score threshold's pixel ``counts``
# where the score map is 32^2 (MaNet's stride 8)
ZOO_CHECK = {'CpnConvNeXtBaseUNet': {}, 'CpnConvNeXtV2TinyUNet': dict(score=0.2, fourier=0.1),
             'CpnDenseNet121UNet': dict(score=0.25, fourier=0.25), 'CpnMobileNetV3LargeUNet': {},
             'CpnMobileNetV3SmallFPN': {}, 'CpnResNet50MaNet': dict(counts=(100, 500)),
             'CpnResUNet': dict(score=0.1, fourier=0.1), 'CpnWideU22': {}}
# phase 15: the zoo's main path on 1024^2 tiles (name, runs)
ZOO_PATH = (('CpnConvNeXtBaseUNet', (('fp32', None, 1), ('bf16', torch.bfloat16, 4))),
            ('CpnConvNeXtLargeUNet', (('bf16', torch.bfloat16, 4),)),
            ('CpnDenseNet121UNet', (('bf16', torch.bfloat16, 4),)),
            ('CpnMobileNetV3LargeFPN', (('bf16', torch.bfloat16, 4),)),
            ('CpnResNet50MaNet', (('bf16', torch.bfloat16, 4),)))
_TV_BLOCK = {'dwconv': 0, 'norm': 2, 'mlp0': 3, 'mlp1': 5}


def convnext_torchvision_layout(model, rng):
    """A torchvision-layout ConvNeXt state dict of ``model``'s encoder shapes:
    seeded numpy values, the stem with 3 input channels (the load adapts it
    to the model's) and a classifier (the load drops it)."""
    sd = {}
    for key, t in model.state_dict().items():
        if not key.startswith('core.backbone.body.'):
            continue
        mod, leaf = key[len('core.backbone.body.'):].rsplit('.', 1)
        shape = tuple(t.shape)
        if mod == 'stem_conv' and leaf == 'weight':
            shape = (shape[0], 3) + shape[2:]
        value = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        if mod.startswith('stem'):
            sd[f'features.0.{0 if mod == "stem_conv" else 1}.{leaf}'] = value
        elif mod.startswith('down'):
            stage, part = int(mod[4:mod.index('_')]), mod.rsplit('_', 1)[1]
            sd[f'features.{2 * stage}.{0 if part == "norm" else 1}.{leaf}'] = value
        else:
            block = mod.split('.')[0]
            stage, j = int(block[5:block.index('_')]), int(block.rsplit('block', 1)[1])
            base = f'features.{2 * stage + 1}.{j}'
            if leaf == 'layer_scale':
                sd[f'{base}.layer_scale'] = value.reshape(-1, 1, 1)
            else:
                sd[f'{base}.block.{_TV_BLOCK[mod.split(".")[1]]}.{leaf}'] = value
    sd['classifier.2.weight'] = torch.from_numpy(rng.randn(1000, 768).astype(np.float32))
    return sd


def phase_pretrained(rng):
    """Phase 14b: a synthetic torchvision ConvNeXt-Tiny state dict, written to
    a temporary ``.pth``, loaded through ``backbone_kwargs={'pretrained': path}``
    into a one-channel CpnConvNeXtTinyUNet on the card and on the CPU: the
    encoders bit-equal to each other and to the file (the stem adapted to one
    channel, the classifier dropped)."""
    print('== phase 14b: pretrained ConvNeXt-Tiny encoder from a local .pth (torchvision '
          'layout), card vs CPU', flush=True)
    sd = convnext_torchvision_layout(models.CpnConvNeXtTinyUNet(1, device='cpu',
                                                                torch_init=False), rng)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'convnext_tiny.pth')
        torch.save(sd, path)
        t0 = time.perf_counter()
        gpu_m = models.CpnConvNeXtTinyUNet(1, backbone_kwargs=dict(pretrained=path))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        cpu_m = models.CpnConvNeXtTinyUNet(1, backbone_kwargs=dict(pretrained=path),
                                           device='cpu')
    body = {k: v for k, v in cpu_m.state_dict().items() if k.startswith('core.backbone.body.')}
    gpu = gpu_m.state_dict()
    differ = [k for k, v in body.items() if not torch.equal(gpu[k].cpu(), v)]
    check(not differ, f'pretrained encoders differ on card and CPU: {differ[:4]}')
    check(torch.equal(body['core.backbone.body.stem_conv.weight'], sd['features.0.0.weight'][:, :1])
          and torch.equal(body['core.backbone.body.stage2_block8.mlp1.weight'],
                          sd['features.5.8.block.5.weight'])
          and torch.equal(body['core.backbone.body.stage3_block2.layer_scale'],
                          sd['features.7.2.layer_scale'].reshape(-1)),
          'the encoder is not the file\'s')
    print(f'  {len(body)} encoder tensors ({sum(v.numel() for v in body.values()):,} values) '
          f'loaded: card == CPU == the file (stem adapted from 3 channels to 1); model built and '
          f'loaded on the card in {secs:.2f} s', flush=True)


def phase_zoo(rng, card, errs, floor):
    """Phases 14 and 15: the rest of the zoo. Each new family at full width and
    depth at 256^2, card against CPU (TF32 off, random weights tamed); the
    pretrained load; then the main path of five zoo models on 1024^2 tiles.
    Returns the NMS kernels' launches in phase 15's runs."""
    for name, factors in ZOO_CHECK.items():
        phase_card_vs_cpu(rng, f'phase 14: {name} (full width and depth)',
                          lambda name=name, **kw: models.get_cpn(name)(3, **FLAGSHIP, **kw),
                          tame=True, **factors)
    phase_pretrained(rng)
    launches = dict.fromkeys(LAUNCH_NAMES.values(), 0)
    for name, runs in ZOO_PATH:
        got, _ = main_path(rng, card, errs, floor, f'phase 15: the zoo\'s main path, {name}',
                           lambda name=name, **kw: models.get_cpn(name)(3, **FLAGSHIP, **kw),
                           tame=True, runs=runs,
                           score=ZOO_CHECK.get(name, {}).get('score', 1.))
        launches = {k: launches[k] + got[k] for k in launches}
    print(f'  kernel launches in phase 15 (launches_zoo): {launches}', flush=True)
    return launches


CLI_SIDE = 4096      # phase 16's mosaic: 25 tiles of 1024^2 at stride 768
CLI_PROPERTIES = ['label', 'area', 'centroid', 'bbox']


class SweepRecorder:
    """Keeps every call of the NMS sweep (``kernels.nms.nms_sweep``, which
    ``nms_padded`` and ``nms_chunked`` look up at each call) made inside the
    ``with`` block: its label, inputs, threshold and keep mask, to hold
    against the plain versions afterwards. The kernels' launch counts are
    their own wrappers' and stay as they are."""

    def __init__(self):
        self.calls, self.label = [], None

    def __enter__(self):
        self.sweep = knms.nms_sweep

        def recording(b, v, thresh):
            keep = self.sweep(b, v, thresh)
            order = sum(c[0][0] == self.label for c in self.calls)
            self.calls.append(((self.label, order), b.clone(), v.clone(), thresh, keep.clone()))
            return keep
        knms.nms_sweep = recording
        return self

    def __exit__(self, *exc):
        knms.nms_sweep = self.sweep


def hold_recorded(calls, errs, card, floor, names, timed=()):
    """Each recorded sweep call against its plain versions, bit for bit (each
    kernel, the whole sweep and the recorded keep mask); ``names`` maps a
    call's (label, order in its run) to what it is, and the calls in
    ``timed`` are timed beside their bound and the plain sweep."""
    for key, b, v, t, keep in calls:
        k, _, slots, _ = hold_each(b, v, t, errs)
        label = f'{key[0]} {names[key]}'
        check(torch.equal(k, keep) and torch.equal(k, _nms_sweep(b, v, t)),
              f'{label}: the NMS call and its plain version differ')
        shape = f'{v.shape[0]} x {v.shape[1]}'
        print(f'  NMS call of {label}: {shape}, {int(v.sum())} valid, {int(keep.sum())} kept '
              f'({"slots" if slots else "packed"} layout): every kernel == plain, keep mask == '
              f'plain _nms_sweep', flush=True)
        if key in timed:
            ms, _ = time_sweep(f'B={v.shape[0]} N={v.shape[1]} t={t} ({label})', b, v, keep, t,
                               card, floor)
            plain_ms = cuda_ms(lambda: _nms_sweep(b, v, t), 2, warmup=1)
            print(f'  [{card}] plain _nms_sweep {shape} ({label}): {plain_ms:.3f} ms; nms_sweep '
                  f'{ms:.4f} ms', flush=True)


def spread_thresholds(tiled, tiles):
    """Per model, the score threshold that leaves at most 2000 foreground
    pixels in every tile of ``tiles`` (numpy NHWC), as phase 7 sets it."""
    out = {}
    for name, t in tiled.items():
        highest = []
        for i in range(0, len(tiles), 4):
            x = torch.from_numpy(tiles[i:i + 4]).cuda()
            p = torch.sigmoid(t.model.forward_padded(x, nms=False)['dense_scores'].float())
            highest.append(torch.topk(p.flatten(1), 2001, dim=1).values[:, -1])
        out[name] = float(torch.cat(highest).max())
    return out


def cli_line(card, label, computed, seconds, peak):
    res, sec, stats = computed['result'], computed['seconds'], computed['stats']
    host = ', '.join(f'{k} {1e3 * v:.1f} ms' for k, v in sec.items())
    print(f'  [{card}] {label}: {res["num_tiles"]} tiles in {seconds:.3f} s = '
          f'{res["num_tiles"] / seconds:.3f} tiles/s through infer_input (host clock); by stage: '
          f'{host}; TiledInference of the first model: forwards {stats["forward_ms"]:.1f} ms, '
          f'retries {stats["retry_ms"]:.1f} ms, stitch {stats["stitch_ms"]:.1f} ms, readback '
          f'{stats["readback_ms"]:.1f} ms; {len(res["boxes"])} detections; peak memory '
          f'{peak:.2f} GiB', flush=True)


def phase_cli(rng, card, errs, floor):
    """Phase 16: the batch inference CLI's per-input function on the card, a
    model file loaded by ``resolve_model``, four ways on a 4096^2 uint8 blob
    mosaic; every NMS call of those runs held against its plain version; then
    the function on the card against the CPU on a 640^2 mosaic."""
    print('== phase 16: the batch inference CLI (tiled_models, infer_input) on the card, '
          'CpnU22 (full width, spread heads) from a cdt file, 4096^2 uint8 blob mosaic, tile '
          '1024, stride 768', flush=True)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    mosaic = np.round(blob_mosaic(CLI_SIDE) * 255).astype(np.uint8)
    stride = 3 * TILE // 4
    src = models.CpnU22(in_channels=1, max_detections=2048, samples=32, device='cpu')
    src.load_state_dict(random_weights(src, score=0.25, fourier=0.1), strict=True)  # phase 7's
    runs = {'a': ('fp32 batch 1, labels, flat labels, properties, overlay', '32', 1,
                  dict(labels=True, flat_labels=True, properties=CLI_PROPERTIES, overlay=True)),
            'b': ('bf16 batch 4', 'bf16', 4, {}),
            'c': ('fp32 batch 1, ensemble of the file twice, min_vote 2', '32', 1,
                  dict(min_vote=2)),
            'd': ('fp32 batch 1, reps 2', '32', 1, dict(reps=2))}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'cpnu22.cdt')
        save_model(path, src)
        tiled, load_s = {}, {}
        for key, (_, precision, batch, opts) in runs.items():
            t0 = time.perf_counter()
            tiled[key] = tiled_models([path, path] if 'min_vote' in opts else path, 'cuda',
                                      precision=precision, tile_size=TILE, stride=stride,
                                      batch_size=batch)
            torch.cuda.synchronize()
            load_s[key] = time.perf_counter() - t0
    img = preprocess(mosaic, to_rgb=False)
    tiles = tile_image(img, TILE, stride)[0]
    num_tiles = len(tiles)
    thresh = spread_thresholds({'32': tiled['a'][0], 'bf16': tiled['b'][0]}, tiles)
    del tiles
    print(f'  model file loaded by resolve_model onto the card in '
          f'{", ".join(f"{k} {v:.2f} s" for k, v in load_s.items())}; thresholds {thresh} (at '
          f'most 2000 foreground pixels in every tile)', flush=True)
    for key, (_, precision, _, _) in runs.items():
        for t in tiled[key]:
            t.model.score_thresh = thresh[precision]
        infer_input(mosaic[:2 * TILE, :2 * TILE], tiled[key], reps=runs[key][3].get('reps', 1))
    torch.cuda.synchronize()

    reset_launches()                   # the CLI's run: counts from 0
    out = {}
    with SweepRecorder() as rec:
        for key, (label, _, _, opts) in runs.items():
            rec.label = f'16{key}'
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out[key] = infer_input(mosaic, tiled[key], name='mosaic', **opts)
            seconds = time.perf_counter() - t0
            cli_line(card, f'16{key} {label}', out[key], seconds,
                     torch.cuda.max_memory_allocated() / 2 ** 30)
    launches = read_launches()
    print(f'  kernel launches in the CLI run (launches_cli): {launches}', flush=True)
    check(all(n > 0 for n in launches.values()), 'a kernel of the CLI path was never launched')

    a = out['a']
    res = a['result']
    n = len(res['boxes'])
    check(res['num_tiles'] == num_tiles and n > 0 and not res['overflow'], '16a: tiles or detections')
    check(res['contours'].shape == (n, 32, 2) and np.isfinite(res['contours']).all(),
          '16a: contours')
    check(a['labels'].shape[:2] == (CLI_SIDE, CLI_SIDE) and 0 < a['labels'].max() <= n, '16a: labels')
    check(a['flat_labels'].shape == (CLI_SIDE, CLI_SIDE) and 0 < a['flat_labels'].max() <= n,
          '16a: flat labels')
    check(a['table'].columns == ['label', 'area', 'centroid-0', 'centroid-1', 'bbox-0',
                                 'bbox-1', 'bbox-2', 'bbox-3']
          and len(a['table']) == len(np.unique(a['flat_labels'])) - 1, '16a: the table')
    check(a['overlay'].shape == (CLI_SIDE, CLI_SIDE, 4) and
          ((a['overlay'][..., 3] > 0) == (a['labels'] > 0).any(-1)).all(), '16a: the overlay')
    n_b = len(out['b']['result']['boxes'])
    check(n_b > 0 and np.isfinite(out['b']['result']['contours']).all(), '16b: detections')
    # the same model twice: every box has two votes, so the ensemble keeps
    # what the single model keeps (tests/test_runtime.py's gate)
    n_c, n_d = len(out['c']['result']['boxes']), len(out['d']['result']['boxes'])
    print(f'  detections: fp32 {n}, bf16 {n_b}, ensemble {n_c}, reps 2 {n_d}; rows in the table '
          f'{len(a["table"])}', flush=True)
    check(abs(n_c - n) <= 1, f'16c: the ensemble keeps {n_c}, the single model {n}')
    check(out['c']['result']['num_tiles'] == out['d']['result']['num_tiles'] == 2 * num_tiles
          and n_d > 0,
          '16c/d: tiles or detections')
    names = {('16a', 0): 'stitch', ('16b', 0): 'stitch', ('16c', 0): 'stitch, model 1',
             ('16c', 1): 'stitch, model 2', ('16c', 2): 'final NMS of the ensemble',
             ('16d', 0): 'stitch', ('16d', 1): 'stitch, flipped',
             ('16d', 2): 'final NMS of the flips'}
    check(sorted(c[0] for c in rec.calls) == sorted(names),
          f'NMS calls {[c[0] for c in rec.calls]}, not {sorted(names)}')
    hold_recorded(rec.calls, errs, card, floor, names,
                  timed=(('16a', 0), ('16c', 2), ('16d', 2)))
    ref = dict(inputs=dict(cli_state=src.state_dict(), cli_thresh=thresh['32'], mosaic_cli=mosaic),
               cli_result=a['result'], cli_flat=a['flat_labels'])
    del out, tiled, a
    torch.cuda.empty_cache()
    phase_cli_card_vs_cpu(rng)
    return launches, ref


def rounded_alike(a, b, match):
    """Per detection of ``a``: do its contour and that of ``b`` it matches
    round to the same pixels?"""
    return (np.round(a['contours']) == np.round(b['contours'][match])).all((1, 2))


def region_border(labels):
    """Pixels with a 4-neighbour of another label: where a fill that reads
    the contours unrounded may go either way."""
    out = np.zeros(labels.shape, bool)
    for a, b in ((np.s_[1:], np.s_[:-1]), (np.s_[:-1], np.s_[1:])):
        out[a, :] |= labels[a, :] != labels[b, :]
        out[:, a] |= labels[:, a] != labels[:, b]
    return out


def phase_cli_card_vs_cpu(rng):
    """Phase 16, card against CPU: ``infer_input`` of full-width CpnU22 (phase
    4's weights, fp32, TF32 off) on a 640^2 uint8 mosaic in 256^2 tiles at
    stride 192 with every output, as phase 6 runs ``TiledInference``."""
    print('== phase 16: infer_input on the card against the CPU, CpnU22 (full width, fp32, TF32 '
          'off), 640^2 uint8 mosaic in 256^2 tiles at stride 192, every output', flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu_m = models.CpnU22(in_channels=3, device='cpu')
    sd = random_weights(cpu_m)
    cpu_m.load_state_dict(sd, strict=True)
    gpu_m = models.CpnU22(in_channels=3)
    gpu_m.load_state_dict(sd, strict=True)
    image = (rng.rand(640, 640, 3) * 255).astype(np.uint8)
    tiles = torch.from_numpy(tile_image(preprocess(image), 256, 192)[0])
    with torch.no_grad():
        p_cpu = torch.sigmoid(cpu_m.core(tiles)['scores'])
        p_err = float((torch.sigmoid(gpu_m.core(tiles.cuda())['scores']).cpu() - p_cpu).abs().max())
    thresh, gap = threshold_in_gap(p_cpu.numpy(), 9 * 300, 9 * 1500)
    check(gap > 4 * p_err, f'score gap {gap} too narrow for the card-cpu difference {p_err}')
    opts = dict(labels=True, flat_labels=True, properties=CLI_PROPERTIES, overlay=True,
                overlay_seed=SEED)
    got = {}
    for dev, m in (('cpu', cpu_m), ('cuda', gpu_m)):
        tl = tiled_models(m, dev, score_thresh=thresh, tile_size=256, stride=192, batch_size=3)
        t0 = time.perf_counter()
        got[dev] = infer_input(image, tl, **opts)
        got[dev]['wall'] = time.perf_counter() - t0
    c, g = got['cpu'], got['cuda']
    rc, rg = c['result'], g['result']
    print(f'  threshold {thresh:.6f} (gap {gap:.2e}, score diff {p_err:.2e}); CPU '
          f'{c["wall"]:.1f} s, card {g["wall"]:.2f} s; tiles {rc["num_tiles"]} / '
          f'{rg["num_tiles"]}, kept {rc["num_valid"]} / {rg["num_valid"]} (cpu / card)',
          flush=True)
    for key in ('num_tiles', 'num_valid', 'overflow'):
        check(rc[key] == rg[key], f'infer_input {key} differs: {rc[key]} and {rg[key]}')
    match = match_detections(rc, rg)
    check(match is not None, 'the kept detections of the card and the CPU differ')
    diffs = np.abs(rg['contours'][match] - rc['contours'])
    frac = float((diffs <= 1e-3).all(-1).mean())
    check(frac >= 0.99 and float(diffs.mean()) < 0.1, 'contours differ beyond the gates')
    # the labels and the overlay follow from the contours rounded to pixels
    # and from their order (label = place + 1, the colours drawn in order):
    # they must be equal outside the boxes of the detections that round
    # differently or sit elsewhere in the order. The flat labels' native fill
    # reads the contours unrounded (as the JAX package's does), so a pixel
    # centre within rounding of an edge may fall either side: such pixels
    # must lie on a region's border and be few (1e-3 of the foreground), and
    # the table rows of their regions are left out.
    n = len(match)
    alike = rounded_alike(rc, rg, match)
    moved = match != np.arange(n)
    odd = np.nonzero(~alike | moved)[0]
    mask = np.zeros((640, 640), bool)
    for j in odd:
        for con in (rc['contours'][j], rg['contours'][match[j]]):
            x0, y0 = np.maximum(np.floor(con.min(0)).astype(int) - 4, 0)
            x1, y1 = np.ceil(con.max(0)).astype(int) + 5
            mask[y0:y1, x0:x1] = True
    lut = np.zeros(n + 1, np.int64)
    lut[match + 1] = np.arange(1, n + 1)           # card label -> the CPU's label
    flat_g = lut[g['flat_labels']]
    edge = (flat_g != c['flat_labels']) & ~mask
    fg = int((c['flat_labels'] > 0).sum())
    check(edge.sum() <= 1e-3 * fg and not (edge & ~(region_border(flat_g) |
                                                    region_border(c['flat_labels']))).any(),
          f'flat labels differ on {int(edge.sum())} of {fg} pixels where contours agree, or '
          f'off the border of a region')
    lab_g, lab_c = lut[g['labels']].max(-1), c['labels'].max(-1)
    check((lab_g == lab_c)[~mask].all(), 'labels differ where contours agree')
    check((g['overlay'] == c['overlay'])[~mask].all(), 'overlays differ where contours agree')
    # table rows of the regions that no such box touches
    rows_c = {r['label']: r for r in c['table'].rows}
    rows_g = {int(lut[r['label']]): r for r in g['table'].rows}
    touched = set(np.unique(c['flat_labels'][mask | edge])) | set(np.unique(flat_g[mask | edge]))
    same = [lbl for lbl in rows_c if lbl not in touched]
    check(c['table'].columns == g['table'].columns and all(
        lbl in rows_g and {k: v for k, v in rows_g[lbl].items() if k != 'label'} ==
        {k: v for k, v in rows_c[lbl].items() if k != 'label'} for lbl in same),
        'table rows differ where contours agree')
    if not len(odd):
        check(np.array_equal(g['labels'], c['labels']) and
              np.array_equal(g['overlay'], c['overlay']), 'outputs differ')
    print(f'  same keep set; contours: {100 * frac:.2f}% of points within 1e-3 px, mean |diff| '
          f'{float(diffs.mean()):.2e} px; {n - len(odd)} of {n} detections round to the same '
          f'pixels in the same place ({int(moved.sum())} elsewhere in the order): labels and '
          f'the overlay equal outside {100 * mask.mean():.2f}% of the image around the others, '
          f'flat labels there but for {int(edge.sum())} of {fg} foreground pixels at an edge, '
          f'{len(same)} of {len(rows_c)} table rows equal', flush=True)


# phase 17: every head option of the JAX package's CPN at once (the
# certainty threshold is set by each phase from the model's own uncertainties)
HEADS = dict(uncertainty_head=True, uncertainty_nms=True, refinement_buckets=3,
             contour_features=('1', '2'), refinement_features=('0', '1'))


def phase_heads(rng, card, errs, floor):
    """Phase 17: CpnU22 with the head options, card against CPU at 256^2 (the
    certainty cut in a gap of the mean uncertainties), then its main path on
    1024^2 tiles with the uncertainty-weighted NMS calls held against their
    plain versions. Returns the NMS kernels' launches of the main path."""
    phase_card_vs_cpu(rng, 'phase 17: CpnU22 with the uncertainty head and NMS, refinement '
                      'buckets 3, fused levels (full width)',
                      lambda **kw: models.CpnU22(in_channels=3, **HEADS, **kw))
    launches, _ = main_path(rng, card, errs, floor, 'phase 17: main path, CpnU22 with the head '
                            'options (full width)',
                            lambda **kw: models.CpnU22(in_channels=3, max_detections=2048,
                                                       samples=32, **HEADS, **kw))
    print(f'  kernel launches in phase 17 (launches_heads): {launches}', flush=True)
    return launches


# phase 18: data-parallel training and multi-process tiled inference, two
# ranks on the one card over gloo (a check of correctness, not of scaling)
DDP_RANKS = 2
DDP_K = TRAIN_SIZE * TRAIN_SIZE      # 65,536, the score map's pixels: every fg pixel is selected
DDP_PARITY_STEPS, DDP_TIMED_STEPS = 3, 20
# two-rank losses against one process: the first step's within float32
# rounding of sums in another order; the loss is not smooth (the refinement
# rounds to pixels, the IoU masks boxes by size), so later steps part as two
# runs of the JAX package part with every weight moved by one ulp (up to
# 9e-3 in 4 steps, tests/test_torch_port_train.py)
DDP_RTOL_FIRST, DDP_RTOL = 1e-5, 1e-2


def params_digest(model):
    """sha256 of every parameter's bytes, in order (bit-identity across ranks)."""
    import hashlib
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def dropout_off(model):
    for m in model.modules():
        if isinstance(m, models.Dropout2d):
            m.p = 0.
    return model


def ddp_rank_train(rank, inp, out):
    """(a) make_train_step over the mesh: the parity steps at K = 65,536 (TF32
    off, dropout off), then the timed steps at K = 512."""
    import torch.distributed as dist
    from celldetection_tpu_torch import parallel
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = parallel.make_mesh()
    lo, hi = rank * TRAIN_BATCH // DDP_RANKS, (rank + 1) * TRAIN_BATCH // DDP_RANKS
    local = {k: v[lo:hi] for k, v in inp['train_batch'].items()}
    model = dropout_off(models.CpnU22(in_channels=1, samples=32, max_detections=DDP_K))
    model.load_state_dict(inp['train_state'], strict=True)
    state = TrainState.create(model, conf2optimizer({'Adam': {'lr': 5e-4}}))
    step = make_train_step(model, state.optimizer, mesh=mesh)
    gen = torch.Generator(device='cuda').manual_seed(SEED + rank)
    losses, digests = [], []
    for _ in range(DDP_PARITY_STEPS):
        state, metrics = step(state, local, gen)
        losses.append(float(metrics['loss']))
        digests.append(params_digest(model))
    out['train'] = dict(losses=losses, digests=digests)
    del model, state, step

    torch.backends.cudnn.allow_tf32 = True          # PyTorch's default, as phase 11b
    model = models.CpnU22(in_channels=1, **TRAIN)
    model.load_state_dict(inp['train_state'], strict=True)
    state = TrainState.create(model, conf2optimizer({'Adam': {'lr': 5e-4}}))
    step = make_train_step(model, state.optimizer, mesh=mesh)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in local.items()}
    for _ in range(2):
        step(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(DDP_TIMED_STEPS):
        step(state, batch, gen)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / DDP_TIMED_STEPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the gradient all-reduce alone: every gradient's bytes in one tensor, as
    # DistributedDataParallel's buckets carry them over the same group
    numel = sum(p.numel() for p in model.parameters())
    flat = torch.zeros(numel, device='cuda')
    dist.all_reduce(flat)
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        dist.all_reduce(flat)
    torch.cuda.synchronize()
    allreduce_ms = (time.perf_counter() - t0) / 5 * 1e3
    out['train'].update(step_ms=step_s * 1e3, imgs_s=TRAIN_BATCH / step_s, peak=peak,
                        allreduce_ms=allreduce_ms, allreduce_bytes=4 * numel, params=numel)
    del model, state, step, flat
    torch.cuda.empty_cache()


def ddp_rank_tiles(rank, inp, out, errs):
    """(b) multihost_tiled_inference of phase 7's 8192^2 mosaic (fp32 b1), its
    NMS calls recorded and held against the plain versions."""
    import torch.distributed as dist
    from celldetection_tpu_torch.parallel import multihost_tiled_inference
    torch.backends.cudnn.allow_tf32 = True          # as phase 7's fp32 run
    torch.backends.cuda.matmul.allow_tf32 = False
    model = models.CpnU22(in_channels=1, max_detections=2048, samples=32)
    model.load_state_dict(inp['tiles_state'], strict=True)
    tiled = TiledInference(model, tile_size=TILE, stride=768, batch_size=1, max_outputs=400_000)
    mosaic, thresh = inp['mosaic8'], inp['tiles_thresh']
    multihost_tiled_inference(tiled, mosaic[:2 * TILE, :2 * TILE], score_thresh=thresh)   # warm-up
    torch.cuda.synchronize()
    dist.barrier()
    reset_launches()                    # the path's run: counts from 0
    with SweepRecorder() as rec:
        rec.label = '18b'
        t0 = time.perf_counter()
        res = multihost_tiled_inference(tiled, mosaic, score_thresh=thresh)
        seconds = time.perf_counter() - t0
    launches = read_launches()
    stats = dict(tiled.stats)
    out['tiles'] = dict(result=res, seconds=seconds, stats=stats, launches=launches,
                        calls=[(c[0], tuple(c[2].shape), int(c[2].sum()), int(c[4].sum()))
                               for c in rec.calls])
    names = {c[0]: f'rank {rank} local stitch' if c[0][1] == 0 else 'final NMS across ranks'
             for c in rec.calls}
    # every call against its plain versions on both ranks; rank 0 times its own
    hold_recorded(rec.calls, errs, f'rank {rank}', 0., names)
    dist.barrier()
    if rank == 0:           # the local stitch and the last round of the final NMS
        floor = launch_floor_ms()
        card = card_line()
        for key, b, v, t, keep in (rec.calls[0], rec.calls[-1]):
            ms, _ = time_sweep(f'B={v.shape[0]} N={v.shape[1]} t={t} ({names[key]})', b, v, keep,
                               t, card, floor)
            plain_ms = cuda_ms(lambda: _nms_sweep(b, v, t), 1, warmup=0)
            print(f'  [{card}] plain _nms_sweep {v.shape[0]} x {v.shape[1]} ({names[key]}): '
                  f'{plain_ms:.3f} ms; nms_sweep {ms:.4f} ms', flush=True)
    dist.barrier()
    del rec
    torch.cuda.empty_cache()


def ddp_rank_validate(rank, inp, out):
    """(c) validate(distributed=True) of phase 13's model over its 4 images."""
    torch.backends.cudnn.allow_tf32 = False         # as phase 13's validate
    torch.backends.cuda.matmul.allow_tf32 = False
    model = models.CpnU22(in_channels=1, **TRAIN)
    model.load_state_dict(inp['val_state'], strict=True)
    trainer = CPNTrainer(model, val_hparams=inp['val_hparams'], log_fn=lambda *a: None, seed=SEED)
    t0 = time.perf_counter()
    metrics = trainer.validate(inp['val_data'], distributed=True)
    out['validate'] = dict(metrics=metrics, seconds=time.perf_counter() - t0,
                           counts=[r['counts'] for r in trainer.val_results])


def ddp_rank_cli(rank, inp, out):
    """(d) cpn_inference of phase 16's 4096^2 mosaic under 'rank' (two inputs)
    and 'job' (one); the writer records instead of writing (the card's machine
    has no h5py)."""
    cli = sys.modules['celldetection_tpu_torch.runtime.cpn_inference']
    torch.backends.cudnn.allow_tf32 = True          # as phase 16
    torch.backends.cuda.matmul.allow_tf32 = False
    model = models.CpnU22(in_channels=1, max_detections=2048, samples=32)
    model.load_state_dict(inp['cli_state'], strict=True)
    written = []
    cli.write_outputs = lambda outputs, computed, args: written.append(
        (computed['name'], computed['result'], computed['flat_labels']))
    kw = dict(tile_size=TILE, stride=768, score_thresh=inp['cli_thresh'], accelerator='cuda:0',
              flat_labels=True, outputs=os.path.join(inp['tmp'], 'cli'))
    mosaic = inp['mosaic_cli']
    t0 = time.perf_counter()
    cli.cpn_inference([mosaic, mosaic], model, group_level='rank', **kw)
    t1 = time.perf_counter()
    cli.cpn_inference([mosaic], model, group_level='job', **kw)
    out['cli'] = dict(written=written, rank_s=t1 - t0, job_s=time.perf_counter() - t1)


def ddp_rank(rank, port, tmp):
    """One rank of phase 18 (a process of its own, on cuda:0)."""
    import torch.distributed as dist
    from celldetection_tpu_torch.parallel import initialize_distributed
    initialize_distributed(f'localhost:{port}', DDP_RANKS, rank, backend='gloo', device='cuda:0',
                           timeout=600)
    inp = torch.load(os.path.join(tmp, 'inputs.pt'), weights_only=False)
    inp['tmp'] = tmp
    out, errs = {}, {}
    try:
        t0 = time.perf_counter()
        ddp_rank_train(rank, inp, out)
        out['train_s'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ddp_rank_tiles(rank, inp, out, errs)
        out['tiles_s'] = time.perf_counter() - t0
        ddp_rank_validate(rank, inp, out)
        ddp_rank_cli(rank, inp, out)
        out['errs'] = errs
        torch.save(out, os.path.join(tmp, f'rank{rank}.pt'))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def same_result(a, b):
    """Two tiled results equal bit for bit."""
    return (all(np.array_equal(a[k], b[k]) for k in ('contours', 'boxes', 'scores', 'classes',
                                                     'locations', 'fourier'))
            and all(a[k] == b[k] for k in ('num_tiles', 'num_valid', 'overflow')))


def kept_difference(a, b):
    """How many of ``a``'s boxes ``b`` lacks, and the other way round (bit for bit)."""
    sa = {r.tobytes() for r in a['boxes']}
    sb = {r.tobytes() for r in b['boxes']}
    return len(sa - sb), len(sb - sa)


def phase_ddp(card, errs, refs):
    """Phase 18: two ranks on the one card over gloo drive the data-parallel
    training step, multihost_tiled_inference, validate(distributed=True) and
    cpn_inference; each held against one process. ``refs``: phase 7's fp32
    model, threshold, mosaic and result; phase 13's model, sweep, images and
    results; phase 16's model, threshold, mosaic and 16a's outputs. Returns
    the NMS kernels' launches in (b), summed over the ranks."""
    import torch.multiprocessing as mp
    print(f'== phase 18: {DDP_RANKS} ranks on cuda:0 over gloo (torch.distributed; the tensors '
          f'stay on the card, gloo stages the collectives through the host: correctness, not '
          f'scaling)', flush=True)
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pairs = disk_images(TRAIN_BATCH, TRAIN_SIZE, SEED + 18)
    batch = train_batch(pairs, TRAIN['samples'], SEED + 18)
    model = dropout_off(models.CpnU22(in_channels=1, samples=32, max_detections=DDP_K))
    sd = random_weights(model)
    model.load_state_dict(sd, strict=True)
    state = TrainState.create(model, conf2optimizer({'Adam': {'lr': 5e-4}}))
    step = make_train_step(model, state.optimizer)
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    single = [float(step(state, batch, gen)[1]['loss']) for _ in range(DDP_PARITY_STEPS)]
    del model, state, step
    torch.cuda.empty_cache()
    inputs = dict(train_state={k: v.cpu() for k, v in sd.items()}, train_batch=batch,
                  **refs['inputs'])
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(inputs, os.path.join(tmp, 'inputs.pt'))
        t0 = time.perf_counter()
        mp.start_processes(ddp_rank, args=(free_port(), tmp), nprocs=DDP_RANKS,
                           start_method='spawn')
        ranks_s = time.perf_counter() - t0
        outs = [torch.load(os.path.join(tmp, f'rank{r}.pt'), weights_only=False)
                for r in range(DDP_RANKS)]
    for o in outs:
        for name, err in o['errs'].items():
            errs[name] = max(errs.get(name, 0.), err)
    a, b = outs
    fails = []

    def expect(cond, msg):
        if not cond:
            fails.append(msg)
            print(f'  FAILED: {msg}', flush=True)

    # (a) training
    ta, tb = a['train'], b['train']
    print(f'  (a) make_train_step over 2 ranks, full-width CpnU22 (one channel), '
          f'{TRAIN_SIZE}^2, global batch {TRAIN_BATCH} ({TRAIN_BATCH // DDP_RANKS} a rank), '
          f'Adam 5e-4: {DDP_PARITY_STEPS} parity steps at K {DDP_K} (TF32 off, dropout off): '
          f'losses {ta["losses"]} (rank 1 {tb["losses"]}), one process on the union batch '
          f'{single}; largest relative difference '
          f'{[abs(x - y) / abs(y) for x, y in zip(ta["losses"], single)]} (rtol '
          f'{DDP_RTOL_FIRST} for the first step, {DDP_RTOL} after it); parameters '
          f'bit-identical across the ranks after every step: {ta["digests"] == tb["digests"]}',
          flush=True)
    expect(ta['digests'] == tb['digests'], 'the ranks\' parameters differ')
    expect(ta['losses'] == tb['losses'], 'the ranks\' losses differ')
    expect(np.allclose(ta['losses'][0], single[0], rtol=DDP_RTOL_FIRST, atol=0)
           and np.allclose(ta['losses'], single, rtol=DDP_RTOL, atol=0),
           'two-rank losses differ from one process\'s')
    for r, t in enumerate((ta, tb)):
        print(f'  [{card}] (a) rank {r}: {DDP_TIMED_STEPS} timed steps at K '
              f'{TRAIN["max_detections"]}: {t["step_ms"]:.2f} ms a step, {t["imgs_s"]:.3f} '
              f'imgs/s (global batch, host clock); the gradient all-reduce alone {t["allreduce_ms"]:.2f} ms for '
              f'{t["allreduce_bytes"]} bytes ({t["params"]} parameters, gloo through the host); '
              f'peak memory {t["peak"]:.2f} GiB', flush=True)

    # (b) multi-process tiled inference
    ra, rb = a['tiles']['result'], b['tiles']['result']
    want = refs['tiles_result']
    for r, o in enumerate(outs):
        t = o['tiles']
        st = t['stats']
        print(f'  [{card}] (b) rank {r}: multihost_tiled_inference 8192^2 fp32 b1, '
              f'{ra["num_tiles"]} tiles over 2 ranks in {t["seconds"]:.3f} s = '
              f'{ra["num_tiles"] / t["seconds"]:.3f} tiles/s; forwards {st["forward_ms"]:.1f} ms '
              f'({st["num_tiles"]} tiles), retries {st["retry_ms"]:.1f} ms, local stitch '
              f'{st["stitch_ms"]:.1f} ms, exchange {st["exchange_ms"]:.1f} ms '
              f'({st["exchange_bytes"]} bytes received), final NMS {st["final_nms_ms"]:.1f} ms, '
              f'readback {st["readback_ms"]:.1f} ms; final NMS rounds {st["rounds"]}, rows '
              f'restored {st["restored"]}; NMS calls (B x N, valid, kept) '
              f'{t["calls"]}; launches {t["launches"]}', flush=True)
    expect(same_result(ra, rb), 'the ranks\' tiled results differ')
    kept_same = same_result(ra, want)
    only = kept_difference(ra, want)
    print(f'  (b) both ranks: {ra["num_valid"]} kept, overflow {ra["overflow"]}; phase 7 (one '
          f'process): {want["num_valid"]} kept; bit-equal to phase 7\'s: {kept_same} (boxes '
          f'kept only here {only[0]}, only in phase 7 {only[1]})', flush=True)
    expect(ra['num_tiles'] == 121 and not ra['overflow'], '(b): tiles or overflow')
    expect(kept_same, '(b): the kept set differs from phase 7\'s')
    launches = {k: a['tiles']['launches'][k] + b['tiles']['launches'][k]
                for k in a['tiles']['launches']}
    print(f'  kernel launches in (b), both ranks (launches_ddp): {launches}', flush=True)
    expect(all(n > 0 for n in launches.values()),
           'a kernel of the multi-rank path was never launched')

    # (c) distributed validation
    va, vb = a['validate'], b['validate']
    one = refs['val_results']
    for ca, cb, full in zip(va['counts'], vb['counts'], one):
        both = np.zeros_like(full['counts'])
        both[0::2], both[1::2] = ca, cb
        expect(np.array_equal(both, full['counts']),
               f'(c) {full["setting"]}: the ranks\' counts differ from one process\'s')
    print(f'  (c) validate(distributed=True) over 2 ranks, {len(one)} settings x 4 images in '
          f'{va["seconds"]:.2f} s (rank 0): counts per image equal one process\'s; best '
          f'{va["metrics"]["best_hparams"]} (one process {refs["val_best"]}), f1_np '
          f'{va["metrics"]["f1_np"]:.4f}', flush=True)
    expect(va['metrics'] == vb['metrics'], '(c): the ranks\' metrics differ')
    expect(va['metrics']['best_hparams'] == refs['val_best'], '(c): best_hparams differ')

    # (d) the CLI
    want16, flat16 = refs['cli_result'], refs['cli_flat']
    wa, wb = a['cli']['written'], b['cli']['written']
    expect([w[0] for w in wa] == ['array0', 'array0'] and [w[0] for w in wb] == ['array1'],
           f'(d) writers: rank 0 {[w[0] for w in wa]}, rank 1 {[w[0] for w in wb]}')
    same = []
    for label, (name, res, flat) in (('rank, input 0', wa[0]), ('rank, input 1', wb[0]),
                                     ('job', wa[1])):
        only = kept_difference(res, want16)
        same.append(same_result(res, want16) and np.array_equal(flat, flat16))
        expect(same[-1], f'(d) {label}: outputs differ from phase 16a\'s (boxes only here '
                         f'{only[0]}, only in 16a {only[1]})')
    print(f'  (d) cpn_inference 4096^2 fp32 b1, 2 ranks: \'rank\' (two inputs, one each) '
          f'{a["cli"]["rank_s"]:.2f} s, \'job\' (one input, tiles split) '
          f'{a["cli"]["job_s"]:.2f} s; writes: rank 0 {[w[0] for w in wa]}, rank 1 '
          f'{[w[0] for w in wb]}; detections and flat labels equal phase 16a\'s (rank input 0, '
          f'rank input 1, job): {same}', flush=True)
    print(f'  phase 18: {time.perf_counter() - t_phase:.1f} s (the ranks {ranks_s:.1f} s: '
          f'training {a["train_s"]:.1f} s, tiles {a["tiles_s"]:.1f} s)', flush=True)
    check(not fails, '; '.join(fails))
    return launches


DEMO_AUG = {'HorizontalFlip': {'p': .5}, 'VerticalFlip': {'p': .5}, 'RandomRotate90': {'p': .5},
            'RandomBrightnessContrast': {'p': .3}, 'ElasticTransform': {'p': .3}}


class AugmentedData:
    """The demos' dataset: items of ``items`` through ``augment`` (numpy's
    global ``RandomState``, as the demos draw it), with the host time spent in
    the augmentation."""

    def __init__(self, items, augment):
        self.items, self.augment, self.seconds = items, augment, 0.

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        item = self.items[i]
        t0 = time.perf_counter()
        image, labels = self.augment(item[0], item[1])
        self.seconds += time.perf_counter() - t0
        return (image, labels) + tuple(item[2:])


def phase_demo_binary(card, errs, floor):
    """Phase 19a: the binary demo's recipe (demos/demo-binary-tpu.ipynb) on the
    port's own modules: ``Config``, ``conf2augmentation`` with the elastic
    warp, ``SynthTrain``, ``CPNTrainer.fit`` of full-width CpnU22 and
    ``TiledInference`` on a ``random_geometric_objects`` mosaic, every NMS
    call held against the plain versions. Returns the NMS kernels' launches
    of the tiled run."""
    conf = ct.Config(in_channels=1, cpn='CpnU22', order=5, samples=32, max_detections=128,
                     score_thresh=.9, nms_thresh=.5, batch_size=8, crop_size=256, images=64,
                     optimizer={'Adam': {'lr': 2e-3}}, augmentation=DEMO_AUG)
    print(f'== phase 19a: the binary demo\'s recipe, {conf.cpn} (full width), config '
          f'{conf.hash()}: SynthTrain(n={conf.images}, 256^2, num=24, radius=(6, 14)) through '
          f'conf2augmentation({list(conf.augmentation)}), batch {conf.batch_size}, Adam 2e-3',
          flush=True)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    synth = SynthTrain(n=conf.images, height=conf.crop_size, width=conf.crop_size, num=24,
                       radius=(6, 14))
    synth_s = time.perf_counter() - t0
    np.random.seed(SEED)
    train = AugmentedData(synth.items, conf2augmentation(conf.augmentation))
    model = getattr(models, conf.cpn)(in_channels=conf.in_channels, order=conf.order,
                                      samples=conf.samples, max_detections=conf.max_detections,
                                      nms_thresh=conf.nms_thresh, score_thresh=conf.score_thresh)
    trainer = CPNTrainer(model, optimizer=conf.optimizer, log_fn=lambda *a: None, seed=SEED)
    fit = dict(batch_size=conf.batch_size, crop_size=conf.crop_size, max_instances=32)
    t0 = time.perf_counter()
    trainer.fit(train, epochs=1, **fit)                       # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    epochs, batches = 2, 2 * (-(-conf.images // conf.batch_size))
    train.seconds = 0.
    t0 = time.perf_counter()
    hist = trainer.fit(train, epochs=epochs, **fit)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    aug_ms = train.seconds / batches * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    hist = hist[-epochs:]                 # the trainer's history holds the warm-up epoch too
    check(len(hist) == epochs and all(np.isfinite(h['loss']) for h in hist), 'fit: bad history')
    train.seconds = 0.
    t0 = time.perf_counter()
    for j in range(4):                                        # the host's part alone
        trainer._make_batch(train, np.arange(8) + 8 * j, conf.samples, conf.order, 32,
                            np.random.RandomState(j), crop_size=conf.crop_size)
    made_ms = (time.perf_counter() - t0) / 4 * 1e3
    target_ms = made_ms - train.seconds / 4 * 1e3
    n_imgs = batches * conf.batch_size
    print(f'  [{card}] end to end {n_imgs / wall:.3f} imgs/s ({epochs} epochs, {n_imgs} images '
          f'in {wall:.3f} s; warm-up epoch {warm_s:.1f} s); host ms a batch: augmentation '
          f'{aug_ms:.1f} (in fit), targets {target_ms:.1f} (alone); SynthTrain made in '
          f'{synth_s:.2f} s; peak memory {peak:.2f} GiB; losses by epoch '
          f'{[round(h["loss"], 3) for h in hist]}', flush=True)

    mosaic, _ = random_geometric_objects(3 * conf.crop_size, 3 * conf.crop_size, num=50,
                                         radius=(6, 14), seed=9999)
    tiled = TiledInference(model, tile_size=conf.crop_size, stride=conf.crop_size * 3 // 4)
    # the briefly trained model's scores sit below the demo's 0.9: the
    # threshold leaves at least 512 pixels of the mosaic's first tile above it
    x = torch.from_numpy(mosaic[None, :conf.crop_size, :conf.crop_size, None].copy()).cuda()
    probs = torch.sigmoid(model.forward_padded(x, nms=False)['dense_scores'].float())
    thresh = min(conf.score_thresh, threshold_above(probs, 512))
    reset_launches()
    with SweepRecorder() as rec:
        rec.label = '19a mosaic'
        t0 = time.perf_counter()
        res = tiled(mosaic.astype(np.float32), score_thresh=thresh)
        torch.cuda.synchronize()
        tiled_s = time.perf_counter() - t0
    launches = read_launches()
    print(f'  [{card}] TiledInference on the {mosaic.shape[0]}^2 mosaic (tile 256, stride 192, '
          f'threshold {thresh:.4f}): {res["num_tiles"]} tiles, {len(res["contours"])} detections '
          f'in {tiled_s:.3f} s; NMS kernel launches {launches}', flush=True)
    check(all(n > 0 for n in launches.values()), '19a: the tiled run launched no NMS kernel')
    check(len(res['contours']) > 0 and np.isfinite(res['contours']).all(), '19a: bad detections')
    hold_recorded(rec.calls, errs, card, floor,
                  {c[0]: f'NMS call {c[0][1]}' for c in rec.calls}, timed=[rec.calls[0][0]])
    return launches


def phase_demo_multiclass(card):
    """Phase 19b: the multiclass demo's recipe (demos/demo-multiclass-tpu.ipynb):
    ``random_geometric_shapes``, CpnU22 with 4 classes and 6 refinement
    buckets, ``conf2tweaks_`` of the batch norms' momentum, Adadelta with
    ``StepLR``; the running statistics of one step against flax's update
    worked out on the card from the same batch."""
    conf = ct.Config(in_channels=3, classes=4, cpn='CpnU22', order=7, samples=128,
                     max_detections=256, nms_thresh=.5, contour_head_stride=2,
                     refinement_iterations=3, refinement_buckets=6,
                     tweaks={'BatchNorm2d': {'momentum': 0.05}},
                     optimizer={'Adadelta': {'lr': 1., 'rho': 0.9}},
                     scheduler={'StepLR': {'step_size': 5, 'gamma': .99}}, batch_size=8, size=256,
                     augmentation={'Transpose': {'p': 0.5}, 'RandomRotate90': {'p': 0.5}})
    print(f'== phase 19b: the multiclass demo\'s recipe, {conf.cpn} (full width), classes '
          f'{conf.classes}, refinement buckets {conf.refinement_buckets}, tweaks {conf.tweaks}, '
          f'Adadelta with StepLR, {conf.size}^2 shapes', flush=True)
    items = []
    for i in range(16):
        image, _, labels, classes = random_geometric_shapes(conf.size, conf.size, seed=i)
        items.append((image.astype(np.float32) / 255., labels, classes))
    np.random.seed(SEED)
    train = AugmentedData(items, conf2augmentation(conf.augmentation))
    model = getattr(models, conf.cpn)(
        in_channels=conf.in_channels, order=conf.order, samples=conf.samples, classes=conf.classes,
        nms_thresh=conf.nms_thresh, contour_head_stride=conf.contour_head_stride,
        refinement_iterations=conf.refinement_iterations,
        refinement_buckets=conf.refinement_buckets, max_detections=conf.max_detections)
    trainer = CPNTrainer(model, optimizer=conf.optimizer,
                         scheduler=ct.conf2scheduler(conf.scheduler), log_fn=lambda *a: None,
                         seed=SEED)
    ct.conf2tweaks_(conf.tweaks, model)                       # after the trainer, as a user may
    norms = [m for m in model.modules() if isinstance(m, models.Norm) and
             m.kind.startswith('batchnorm')]
    check(norms and all(abs(m.momentum - 0.95) < 1e-12 for m in norms),
          '19b: the tweak missed a norm')
    t0 = time.perf_counter()
    hist = trainer.fit(train, epochs=1, batch_size=conf.batch_size, max_instances=64,
                       crop_size=conf.size)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    check(np.isfinite(hist[-1]['loss']), '19b: the loss is not finite')

    batch = trainer._make_batch(train, np.arange(conf.batch_size), conf.samples, conf.order, 64,
                                np.random.RandomState(1), crop_size=conf.size)
    stats, hooks = {}, []
    for m in norms:
        def hook(mod, inputs):
            x = inputs[0].detach().double()
            mean = x.mean((0, 2, 3))
            stats[mod] = (mod.running_mean.double().clone(), mod.running_var.double().clone(),
                          mean, (x.square().mean((0, 2, 3)) - mean.square()).clamp(min=0),
                          float(x.square().mean((0, 2, 3)).max()))
        hooks.append(m.register_forward_pre_hook(hook))
    trainer._step_fn(trainer.state, batch, trainer.generator)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    worst = worst_untweaked = 0.
    for m in norms:
        old_mean, old_var, mean, var, scale = stats[m]
        tol = 1e-5 * max(1., scale)
        err = max(float((m.running_mean.double() - (0.95 * old_mean + 0.05 * mean)).abs().max()),
                  float((m.running_var.double() - (0.95 * old_var + 0.05 * var)).abs().max()))
        worst = max(worst, err / tol)
        worst_untweaked = max(worst_untweaked, float(
            (m.running_var.double() - (0.9 * old_var + 0.1 * var)).abs().max()) / tol)
    print(f'  [{card}] fit: {len(items)} images in {fit_s:.2f} s, loss {hist[-1]["loss"]:.3f}; '
          f'one more step: the running statistics of {len(norms)} batch norms against flax\'s '
          f'update with momentum 0.95 (torch 0.05) from the same batch, worked out in float64 on '
          f'the card: worst |diff| / tol {worst:.3e} (tol 1e-5 of the largest E[x^2], at least '
          f'1e-5); against the untweaked 0.9: {worst_untweaked:.3e}', flush=True)
    check(worst <= 1., '19b: the running statistics do not follow the tweaked momentum')
    check(worst_untweaked > 1., '19b: the tweak did not change the running statistics')


# the Mamba CPN's scans on a 1024^2 tile (d_state 16, expand 2): tokens, d_inner a stage
MAMBA_STAGES = ((65536, 512), (16384, 1024), (4096, 2048), (1024, 4096))


def float64_scan(u, delta, A, B, C, D, block=512):
    """``selective_scan`` in float64 on the operands' device, token by token
    from a zero state (the gains and drives of ``block`` tokens formed at a
    time, then one update a token)."""
    u, delta, A, B, C, D = (t.double() for t in (u, delta, A, B, C, D))
    s = u.new_zeros(u.shape[0], u.shape[2], A.shape[1])
    ys = []
    for t0 in range(0, u.shape[1], block):
        dt = delta[:, t0:t0 + block]
        gain = torch.exp(dt[..., None] * A).transpose(0, 1).contiguous()   # [T, b, d, n]
        drive = ((dt * u[:, t0:t0 + block])[..., None] * B[:, t0:t0 + block, None, :]
                 ).transpose(0, 1).contiguous()
        states = torch.empty_like(gain)
        for i in range(gain.shape[0]):
            s = torch.addcmul(drive[i], gain[i], s, out=states[i])
        ys.append(torch.einsum('tbdn,btn->btd', states, C[:, t0:t0 + block]))
    return torch.cat(ys, 1) + u * D


def scan_share(card, build, runs, size, rng):
    """The Mamba scan's share of ``forward_padded(nms=True)``: CUDA events
    around every ``selective_scan`` call against events around the forward.
    A first forward under the span recorder: every ``mamba.scan`` span of an
    fp32 model counts ``kernel`` 1 (the fused kernel ran), a bf16 model's none."""
    original = mamba.selective_scan
    for name, dtype, batch in runs:
        m = build(compute_dtype=dtype)
        m.load_state_dict(random_weights(m, tame=True), strict=True)
        x = torch.from_numpy(rng.rand(batch, size, size, 3).astype(np.float32)).cuda()
        spans = []

        def timed(*args):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            y = original(*args)
            b.record()
            spans.append((a, b))
            return y

        span_recorder.reset()
        span_recorder.enable()
        try:
            m.forward_padded(x)
            kernel = [r['counts'].get('kernel', 0) for r in span_recorder.collect()
                      if r['name'] == 'mamba.scan']
        finally:
            span_recorder.disable()
            span_recorder.reset()
        check(kernel == [int(dtype is None)] * 4, f'{name}: mamba.scan spans count kernel {kernel}')
        mamba.selective_scan = timed
        try:
            total = []
            for _ in range(3):
                spans.clear()
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                m.forward_padded(x)
                b.record()
                torch.cuda.synchronize()
                total.append((a.elapsed_time(b), sum(s.elapsed_time(e) for s, e in spans)))
        finally:
            mamba.selective_scan = original
        fwd, scan = sorted(total)[1]
        print(f'  [{card}] {name} batch {batch} at {size}^2: forward_padded(nms=True) {fwd:.2f} '
              f'ms, the {len(spans)} selective_scan calls {scan:.2f} ms, share {scan / fwd:.3f} '
              f'(CUDA events, median of 3); the mamba.scan spans count kernel {kernel}', flush=True)
        del m, x
        torch.cuda.empty_cache()


def phase_mamba(rng, card, errs, floor):
    """Phase 19c: CpnResNet50UNet with a ``MambaLayer`` secondary block after
    every stage, full width: the scan on the card against a float64
    sequential scan, card against CPU at 256^2, the main path on 512^2 tiles
    (fp32 batch 1, bf16 batch 4) and the scan's share of the forward.
    Returns the NMS kernels' launches of the main path."""
    print('== phase 19c: selective_scan on the card (the fused kernel) against a float64 '
          'sequential scan', flush=True)
    worst = 0.
    for B, L, D in ((2, 1003, 8),) + tuple((1, L, D) for L, D in MAMBA_STAGES):
        g = np.random.RandomState(SEED + L)
        u, delta = g.randn(B, L, D), np.abs(g.randn(B, L, D)) * 0.1 + 0.01
        A, Bm, Cm = -(np.abs(g.randn(D, 16)) + 0.1), g.randn(B, L, 16), g.randn(B, L, 16)
        args = [torch.from_numpy(a.astype(np.float32)).cuda()
                for a in (u, delta, A, Bm, Cm, g.randn(D))]
        before = LAUNCHES['cdt_selective_scan']
        got = mamba.selective_scan(*args)
        torch.cuda.synchronize()
        want = float64_scan(*args)
        err = float(((got.double() - want).abs() / (1e-5 + 1e-4 * want.abs())).max())
        rel = float((got.double() - want).abs().max() / want.abs().max())
        worst = max(worst, err)
        print(f'  B, L, D, N = {B}, {L}, {D}, 16: max |card - float64| / (1e-5 + 1e-4 |ref|) = '
              f'{err:.4f}; max |card - float64| / max |ref| = {rel:.3e}; kernel launches '
              f'{LAUNCHES["cdt_selective_scan"] - before}', flush=True)
        check(LAUNCHES['cdt_selective_scan'] == before + 1, 'selective_scan took the torch scan')
        check(err <= 1., f'selective_scan on the card differs from the sequential scan at '
              f'{B, L, D}')
        del args, got, want
    print(f'  largest error over the shapes: {worst:.4f} of the tolerance', flush=True)

    def build(**kw):
        return models.CpnResNet50UNet(in_channels=3, backbone_kwargs={
            'secondary_block': models.MambaLayer}, max_detections=2048, samples=32, **kw)
    phase_card_vs_cpu(rng, 'phase 19c: CpnResNet50UNet with MambaLayer (full width, d_state 16, '
                      'd_conv 4, expand 2)', build, tame=True)
    runs = (('fp32', None, 1), ('bf16', torch.bfloat16, 4))
    launches, _ = main_path(rng, card, errs, floor, 'phase 19c: the Mamba path, CpnResNet50UNet '
                            'with MambaLayer (full width)', build, tame=True, runs=runs, size=512)
    scan_share(card, build, runs, 512, rng)
    print('== phase 19c: bf16 batch 4 against fp32, CpnResNet50UNet with MambaLayer, after 12 '
          'steps on 8 toy images of 128^2, on 4 toy images of 512^2', flush=True)
    toy = np.stack([random_geometric_objects(512, 512, num=40, radius=(6, 14), seed=100 + i)[0]
                    for i in range(4)])
    x = torch.from_numpy(np.repeat(toy[..., None], 3, -1).astype(np.float32)).cuda()
    bf16_against_fp32(card, build, random_weights(build(), tame=True), x)
    return launches


UTIL_LISTS, UTIL_BOXES, UTIL_CHUNK = 3, 20_000, 5000   # phase 20a's batched_box_nmsi


def random_box_lists(rng, lists, n, extent=4000.):
    """``lists`` images of ``n`` random boxes (4 to 24 px) with random scores, float32."""
    out = []
    for _ in range(lists):
        xy = rng.rand(n, 2).astype(np.float32) * np.float32(extent)
        wh = rng.rand(n, 2).astype(np.float32) * np.float32(20) + np.float32(4)
        out.append((torch.from_numpy(np.concatenate([xy, xy + wh], 1)),
                    torch.from_numpy(rng.rand(n).astype(np.float32))))
    return out


def phase_utils(rng, card, errs, floor):
    """Phase 20: the NMS entry points, the outline rasteriser, the metrics log,
    the timer and memory utilities and parameter surgery on the card. Returns
    the NMS kernels' launches of (a)."""
    from celldetection_tpu_torch.ops import boxes as tboxes
    from celldetection_tpu_torch.ops import draw as tdraw
    print(f'== phase 20: the utilities on full-width CpnU22 and {TILE}^2 inputs as phase 5',
          flush=True)
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    model = models.CpnU22(in_channels=3, max_detections=2048, samples=32)
    model.load_state_dict(random_weights(model), strict=True)
    x = torch.from_numpy(rng.rand(1, TILE, TILE, 3).astype(np.float32)).cuda()
    probs = torch.sigmoid(model.forward_padded(x, nms=False)['dense_scores'].float())
    pre = model.forward_padded(x, score_thresh=threshold_above(probs, 3072), nms=False)
    v = pre['valid'][0]
    boxes, scores = pre['boxes'][0][v].contiguous(), pre['scores'][0][v].contiguous()
    check(len(boxes) == 2048, f'(a) the forward gave {len(boxes)} boxes, not 2048')
    lists = random_box_lists(rng, UTIL_LISTS, UTIL_BOXES)

    # (a) the NMS entry points, counted from 0
    reset_launches()
    t0 = time.perf_counter()
    kept = tboxes.nms(boxes, scores, model.nms_thresh)
    nms_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    kept_lists = tboxes.batched_box_nmsi([b.cuda() for b, _ in lists],
                                         [s_.cuda() for _, s_ in lists], 0.5, UTIL_CHUNK)
    batched_s = time.perf_counter() - t0
    kept_np = tboxes.nms(boxes.cpu().numpy(), scores.cpu().numpy(), model.nms_thresh)  # to the card
    launches = read_launches()
    check(all(n > 0 for n in launches.values()), '(a) a kernel of the entry points never launched')
    t0 = time.perf_counter()
    want = tboxes.nms(boxes.cpu(), scores.cpu(), model.nms_thresh)
    want_lists = tboxes.batched_box_nmsi([b for b, _ in lists], [s_ for _, s_ in lists], 0.5,
                                         UTIL_CHUNK)
    plain_s = time.perf_counter() - t0
    check(np.array_equal(kept, want) and np.array_equal(kept_np, want),
          '(a) nms on the card differs from the CPU')
    check(all(np.array_equal(a, b) for a, b in zip(kept_lists, want_lists)),
          '(a) batched_box_nmsi on the card differs from the CPU')
    print(f'  [{card}] (a) nms of 2048 boxes: {len(kept)} kept in {1e3 * nms_s:.2f} ms (host '
          f'clock, to the host indices); batched_box_nmsi of {UTIL_LISTS} x {UTIL_BOXES} boxes, '
          f'batch_size {UTIL_CHUNK}: {[len(k) for k in kept_lists]} kept in {1e3 * batched_s:.2f} '
          f'ms; both, and nms of numpy inputs (on the card by default), bit-equal to the plain '
          f'run on the CPU ({plain_s:.1f} s); kernel launches '
          f'(launches_utils) {launches}', flush=True)
    # each kernel of those calls against its plain version, and the sweep timed alone
    for label, (b_in, s_in), t in (('ops.nms', (boxes, scores), model.nms_thresh),
                                   ('batched_box_nmsi, list 0', lists[0], 0.5)):
        b_in, s_in = b_in.cuda()[None], s_in.cuda()[None]
        _, b_, v_ = sort_by_score(b_in, s_in, torch.ones_like(s_in, dtype=torch.bool))
        k_, _, _, _ = hold_each(b_, v_, t, errs)
        check(torch.equal(k_, _nms_sweep(b_, v_, t)), f'(a) {label}: the sweep and plain differ')
        ms, _ = time_sweep(f'B=1 N={v_.shape[1]} t={t} (phase 20a, {label})', b_, v_, k_, t, card,
                           floor)
        plain_ms = cuda_ms(lambda: _nms_sweep(b_, v_, t), 3, warmup=1)
        print(f'  [{card}] plain _nms_sweep B=1 N={v_.shape[1]} ({label}): {plain_ms:.3f} ms; '
              f'nms_sweep {ms:.4f} ms', flush=True)

    # (b) the outline rasteriser
    contours = pre['contours'][0]
    canvas = torch.zeros(TILE, TILE, dtype=torch.int32, device='cuda')
    drawn = tdraw.draw_contours(canvas, contours, valid=v)
    ms = cuda_ms(lambda: tdraw.draw_contours(canvas, contours, valid=v), 20)
    want = tdraw.draw_contours(canvas.cpu(), contours.cpu(), valid=v.cpu())
    check(torch.equal(drawn.cpu(), want), '(b) draw_contours on the card differs from the CPU')
    print(f'  [{card}] (b) draw_contours of {tuple(contours.shape)} contours on a {TILE}^2 canvas: '
          f'{int((drawn > 0).sum())} pixels drawn, equal to the CPU; {ms:.3f} ms a call (CUDA '
          f'events)', flush=True)

    # (c) the metrics log of one epoch of phase 11b's fit
    with tempfile.TemporaryDirectory() as tmp:
        data = disk_images(TRAIN_IMAGES, TRAIN_SIZE, SEED)
        tm = models.CpnU22(in_channels=1, **TRAIN)
        tm.load_state_dict(random_weights(tm), strict=True)
        logger = MetricsLogger(tmp, tensorboard=False)
        trainer = CPNTrainer(tm, optimizer={'Adam': {'lr': 5e-4}}, log_fn=lambda *a: None,
                             seed=SEED, metrics_logger=logger)
        hist = trainer.fit(data, epochs=1, batch_size=TRAIN_BATCH, crop_size=TRAIN_SIZE,
                           prefetch=1)
        with open(logger.path) as f:
            lines = [json.loads(line) for line in f]
    steps = -(-TRAIN_IMAGES // TRAIN_BATCH)
    check(len(lines) == steps and [r['step'] for r in lines] == list(range(1, steps + 1)),
          f'(c) {len(lines)} log lines for {steps} steps')
    check(lines[-1]['loss'] == hist[-1]['loss'] and lines[-1]['ema_loss'] == hist[-1]['ema_loss'],
          '(c) the last log line differs from the trainer\'s history')
    check(all(np.isfinite(r[k]) for r in lines for k in r if k.startswith('loss')),
          '(c) a logged loss is not finite')
    print(f'  [{card}] (c) fit, one epoch of {steps} steps with MetricsLogger: {len(lines)} JSON '
          f'lines, keys {sorted(k for k in lines[0] if k != "time")}, losses '
          f'{[round(r["loss"], 4) for r in lines]}, the last equal to the history', flush=True)

    # (d) timer, memory statistics, total memory, a real out-of-memory error
    for _ in range(2):
        model.forward_padded(x, nms=False)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with timer.Timer('5 forwards', sync=True) as t:
        a.record()
        for _ in range(5):
            model.forward_padded(x, nms=False)
        b.record()
    events_ms = a.elapsed_time(b)
    check(t.seconds * 1e3 >= 0.98 * events_ms, f'(d) Timer {t.seconds} s below the events\' '
                                                f'{events_ms} ms')
    total = torch.cuda.get_device_properties(0).total_memory
    check(system.get_total_memory() == total, '(d) get_total_memory differs from the device\'s')
    stats = system.GpuStats()
    check(stats.dict()['dev0_used'] == torch.cuda.memory_allocated(0), '(d) GpuStats')
    sizes = []
    catcher = system.OomCatcher(attempts=3, factor=0.25, initial=2 * total, verbose=False)
    for size in catcher:
        with catcher:
            sizes.append(size)
            block = torch.empty(size, dtype=torch.uint8, device='cuda')
            del block
    torch.cuda.empty_cache()
    check(catcher.ok and sizes == [2 * total, total // 2],
          f'(d) OomCatcher tried {sizes}, ok {catcher.ok}')
    print(f'  [{card}] (d) Timer(sync=True) around 5 forwards: {1e3 * t.seconds:.2f} ms (host '
          f'clock), CUDA events {events_ms:.2f} ms; GpuStats {stats}; get_total_memory '
          f'{system.get_total_memory()} = the device\'s {total} bytes; OomCatcher asked for '
          f'{[str(system.Bytes(n)) for n in sizes]}: the first raised out of memory, the second '
          f'held', flush=True)

    # (e) surgery: the encoder frozen through three Adam steps; EMA card against CPU
    fm = models.CpnU22(in_channels=1, **TRAIN)
    fm.load_state_dict(random_weights(fm), strict=True)
    opt = surgery.frozen_optimizer({'Adam': {'lr': 1e-3}}, fm, r'^core\.backbone\.')
    frozen = surgery.match_paths(fm, r'^core\.backbone\.')
    before = {n: p.detach().clone() for n, p in fm.named_parameters()}
    ft = CPNTrainer(fm, optimizer=opt, log_fn=lambda *a: None, seed=SEED)
    batch = ft._make_batch(data, np.arange(TRAIN_BATCH), TRAIN['samples'], 5, 128,
                           np.random.RandomState(0), crop_size=TRAIN_SIZE)
    for _ in range(3):
        ft._step_fn(ft.state, dict(batch), ft.generator)
    torch.cuda.synchronize()
    same = [torch.equal(p.detach(), before[n]) for n, p in fm.named_parameters() if n in frozen]
    moved = [not torch.equal(p.detach(), before[n]) for n, p in fm.named_parameters()
             if n not in frozen]
    check(frozen and all(same), '(e) a frozen parameter changed')
    check(any(moved), '(e) no trainable parameter changed')
    new = {n: p.detach() for n, p in fm.named_parameters()}
    got = surgery.ema_update(before, new, decay=0.99)
    want = surgery.ema_update({n: t_.cpu() for n, t_ in before.items()},
                              {n: t_.cpu() for n, t_ in new.items()}, decay=0.99)
    check(all(torch.equal(got[n].cpu(), want[n]) for n in got), '(e) ema_update card and CPU differ')
    print(f'  [{card}] (e) three Adam steps under frozen_optimizer(^core.backbone.): '
          f'{len(same)} frozen parameters bit unchanged, {sum(moved)} of {len(moved)} others '
          f'moved; ema_update of {len(got)} tensors on the card equal to the CPU\'s', flush=True)
    print(f'  phase 20: {time.perf_counter() - t_phase:.1f} s', flush=True)
    return launches


# phase 21: 3-D backbones, CPN heads on encoder levels, the rest of models/commons.py
VOLUME, VOLUME_CHECK = 128, 32     # 21a's timed and card-vs-CPU volume sides
VOLUME_TOL = 1e-4                  # of each map's peak, the CPU tests' gate for 3-D models
BLOCK_TOL = 1e-4                   # 21c, of each output's peak, card against CPU, TF32 off
ENCODER_HEADS = dict(contour_features=('1', 'encoder.1'), score_features='encoder.1')


def seeded(build):
    """``build()`` with torch's default init drawn from seed ``SEED``, in eval mode."""
    torch.manual_seed(SEED)
    return build().eval()


def cast_forward(model, dtype, *inputs):
    """``model`` on ``inputs`` with its weights and inputs cast to ``dtype`` (a
    copy per call, as ``CPN``'s ``compute_dtype`` does); ``None``: as it is."""
    if dtype is None:
        return model(*inputs)
    state = {k: t.to(dtype) if t.is_floating_point() else t for k, t in model.state_dict().items()}
    return torch.func.functional_call(model, state, tuple(x.to(dtype) for x in inputs))


def output_maps(out):
    """The tensors of a model's output (a tensor or a dict of them), by name."""
    return dict(out) if isinstance(out, dict) else {'out': out}


def hold_on_cpu(label, build, inputs, tol):
    """``seeded(build)`` on the card against the same weights on the CPU, TF32
    off: every output map within ``tol`` of its peak; prints one line."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu_m = seeded(build)
    gpu_m = seeded(build).cuda()
    gpu_m.load_state_dict(cpu_m.state_dict(), strict=True)
    xs = [torch.from_numpy(a) for a in inputs]
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = output_maps(cpu_m(*xs))
        cpu_s = time.perf_counter() - t0
        got = output_maps(gpu_m(*[x.cuda() for x in xs]))
    check(sorted(got) == sorted(ref), f'{label}: outputs {sorted(got)} against {sorted(ref)}')
    worst = 0.
    for key, want in ref.items():
        have = got[key].cpu()
        check(have.shape == want.shape and bool(torch.isfinite(have).all()),
              f'{label} {key}: shape {tuple(have.shape)} or non-finite values')
        rel = float((have - want).abs().max()) / max(float(want.abs().max()), 1e-30)
        check(rel <= tol, f'{label} {key}: max |card - cpu| = {rel:.3e} of the peak > {tol}')
        worst = max(worst, rel)
    shapes = ', '.join(f'{k} {tuple(v.shape)}' for k, v in list(ref.items())[:6])
    print(f'  {label}: card == cpu within {worst:.2e} of each map\'s peak (gate {tol}; '
          f'CPU {cpu_s:.1f} s): {shapes}', flush=True)


def phase_volumes(card):
    """Phase 21a: 3-D backbones (``nd=3``) at full width on 128^3 volumes, timed,
    then card against CPU on 32^3 volumes, TF32 off."""
    print(f'== phase 21a: 3-D backbones (nd=3), U22 and the ResNet50 UNet at their default '
          f'widths on 1 x 1 x {VOLUME}^3 volumes', flush=True)
    torch.backends.cudnn.allow_tf32 = True          # PyTorch's default for fp32 convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    full = {'U22': lambda: models.U22(1, 2, nd=3),
            'ResNet50UNet': lambda: models.ResNet50UNet(1, 2, nd=3)}
    volumes = np.random.RandomState(SEED + 20).rand(2, 1, VOLUME, VOLUME, VOLUME)
    for name, build in full.items():
        model = seeded(build).cuda()
        x = torch.from_numpy(volumes.astype(np.float32)).cuda()
        outs = {}
        for label, dtype, batch in (('fp32', None, 1), ('bf16', torch.bfloat16, 2)):
            xb = x[:batch]
            with torch.no_grad():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ms = cuda_ms(lambda: cast_forward(model, dtype, xb), 5, warmup=2)
                out = cast_forward(model, dtype, xb)
                torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            check(tuple(out.shape) == (batch, 2) + (VOLUME,) * 3, f'{name} {label}: shape')
            check(bool(torch.isfinite(out).all()), f'{name} {label}: non-finite output')
            outs[label] = out[:1].float()
            print(f'  [{card}] {name} {label} batch {batch}: {ms:.2f} ms a forward (CUDA events, '
                  f'5 back to back after 2), {batch * 1e3 / ms:.3f} volumes/s, peak memory '
                  f'{peak:.2f} GiB', flush=True)
        dev = float((outs['bf16'] - outs['fp32']).abs().max() / outs['fp32'].abs().max())
        print(f'  {name}: bf16 against fp32 on the first volume, max |diff| {dev:.3e} of the '
              f'fp32 peak (not gated)', flush=True)
        del model, x, outs
        torch.cuda.empty_cache()
    print(f'== phase 21a: 3-D models card vs CPU on {VOLUME_CHECK}^3 volumes, TF32 off',
          flush=True)
    rng = np.random.RandomState(SEED + 21)

    def vol(channels=1, side=VOLUME_CHECK, batch=1):
        return rng.rand(batch, channels, side, side, side).astype(np.float32)

    for name, build in full.items():
        hold_on_cpu(f'{name} (full width)', build, [vol()], VOLUME_TOL)
    narrow = (
        ('ResNet18FPN (base 8, its pool level)',
         lambda: models.ResNet18FPN(1, 32, backbone_kwargs=dict(base_channel=8, nd=3)), [vol()]),
        ('ConvNeXtEncoder (depths 2, 2, 2; 16-64 channels)',
         lambda: models.ConvNeXtEncoder(1, depths=(2, 2, 2), channels=(16, 32, 64), nd=3),
         [vol()]),
        ('DenseNetEncoder (growth 8, blocks 2, 3, 2; 16 initial)',
         lambda: models.DenseNetEncoder(1, growth_rate=8, block_config=(2, 3, 2),
                                        init_features=16, nd=3), [vol()]),
        ('MobileNetV3Small (width 0.5)', lambda: models.MobileNetV3Small(1, width_mult=0.5, nd=3),
         [vol()]),
        ('Ppm (32 to 4 x 8 channels)', lambda: models.Ppm(32, 8, nd=3), [vol(32, 12)]),
        ('PositionWiseAttention (32 channels, 8^3 positions)',
         lambda: models.PositionWiseAttention(32, mid_channels=16, beta=True, nd=3),
         [vol(32, 8)]),
        ('MultiscaleFusionAttention (32 to 16, lateral 24)',
         lambda: models.MultiscaleFusionAttention(32, 16, 24, nd=3), [vol(32, 8), vol(24, 16)]),
    )
    for label, build, inputs in narrow:
        hold_on_cpu(label, build, inputs, VOLUME_TOL)


def phase_encoder_heads(rng, card, errs, floor):
    """Phase 21b: CpnU22 with heads on encoder levels (a decoder level fused with
    the encoder level of its stride, and a score head on that encoder level),
    card against CPU at 256^2 and through the main path on 1024^2 tiles.
    Returns the NMS kernels' launches of the main path."""
    phase_card_vs_cpu(rng, f'phase 21b: CpnU22 with heads on encoder levels {ENCODER_HEADS} '
                      f'(full width)', lambda **kw: models.CpnU22(in_channels=3, **ENCODER_HEADS,
                                                                  **kw))
    launches, _ = main_path(rng, card, errs, floor, 'phase 21b: main path, CpnU22 with heads on '
                            'encoder levels (full width)',
                            lambda **kw: models.CpnU22(in_channels=3, max_detections=2048,
                                                       samples=32, **ENCODER_HEADS, **kw))
    print(f'  kernel launches in phase 21b (launches_encoder_heads): {launches}', flush=True)
    return launches


def phase_blocks(card):
    """Phase 21c: the blocks of ``models/commons.py`` new to the port, card
    against CPU, TF32 off, one line each; attention's ``beta`` set to 0.5 so
    that its product counts."""
    print('== phase 21c: the new commons blocks, card vs CPU, TF32 off', flush=True)
    rng = np.random.RandomState(SEED + 22)

    def with_beta(m):
        with torch.no_grad():
            m.beta.fill_(0.5)
        return m

    cases = (
        ('SelfAttention (64 channels at 64^2: a 4096 x 4096 map)',
         lambda: with_beta(models.SelfAttention(64)), (2, 64, 64, 64)),
        ('SqueezeExcitation (64 channels)', lambda: models.SqueezeExcitation(64), (2, 64, 64, 64)),
        ('LayerNorm2d (64 channels)', lambda: models.LayerNorm2d(64), (2, 64, 64, 64)),
        ('DynamicTanh (64 channels)', lambda: models.DynamicTanh(64), (2, 64, 64, 64)),
        ('BottleneckBlock (64 to 256, stride 2)',
         lambda: models.BottleneckBlock(64, 256, stride=2), (2, 64, 64, 64)),
        ('MinibatchStdLayer (2 groups)', lambda: models.MinibatchStdLayer(2, 2), (4, 64, 64, 64)),
    )
    for label, build, shape in cases:
        x = (rng.randn(*shape) * 2).astype(np.float32)
        hold_on_cpu(f'[{card}] {label}', build, [x], BLOCK_TOL)


def score_gap(a, b):
    """The largest score difference of detections the two sides share
    (by the nearest box), for the report of a count difference."""
    if not len(a['scores']) or not len(b['scores']):
        return float('nan')
    d = np.abs(a['boxes'][:, None] - b['boxes'][None]).max(-1)
    j = d.argmin(1)
    return float(np.abs(a['scores'] - b['scores'][j]).max())


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available', file=sys.stderr)
        return 1
    check(os.path.dirname(os.path.abspath(ct.__file__)) == os.path.join(HERE, 'celldetection_tpu_torch'),
          f'the port was imported from {ct.__file__}, not from this checkout')

    t_start = time.perf_counter()
    print('== phase 1: device', flush=True)
    card = card_line()
    print(card, flush=True)
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}, '
          f'{torch.cuda.device_count()} device(s): {torch.cuda.get_device_name(0)}', flush=True)
    check(torch.cuda.device_count() >= 1, 'no card')

    print('== phase 2: build the kernels', flush=True)
    with ThreadPoolExecutor() as pool:                  # one nvcc per source, all at once
        built = list(pool.map(lambda load: load(),
                              (bits_library, resolve_library, head_conv_library,
                               selective_scan_library)))
    for lib in built:
        print(f'  {os.path.relpath(lib.path, HERE)}: built in {lib.build_seconds:.2f} s '
              f'(0 = reused)\n{lib.log.strip()}', flush=True)

    rng = np.random.RandomState(SEED)
    errs = {}
    floor = phase_kernels(rng, card, errs)
    phase_card_vs_cpu(rng, 'phase 4: CpnU22 (full width)',
                      lambda **kw: models.CpnU22(in_channels=3, **kw))
    launches, rec = main_path(rng, card, errs, floor, 'phase 5: main path, CpnU22 (full width)',
                              lambda **kw: models.CpnU22(in_channels=3, max_detections=2048,
                                                         samples=32, **kw))
    phase_tiled_card_vs_cpu(rng)
    launches_tiled, tiles_ref = phase_gigapixel(card, floor)
    phase_card_vs_cpu(rng, 'phase 8: CpnResNeXt101UNet (full width and depth)',
                      lambda **kw: models.CpnResNeXt101UNet(in_channels=3, **FLAGSHIP, **kw),
                      tame=True)
    # K above the 64^2 score map's pixels: every foreground pixel is selected
    phase_card_vs_cpu(rng, 'phase 8: CpnResNet18FPN, 3 classes',
                      lambda **kw: models.CpnResNet18FPN(in_channels=3, classes=3,
                                                         max_detections=4096, **kw), tame=True)
    launches_resnet, rec_resnet = main_path(
        rng, card, errs, floor, 'phase 9: the ResNet path, CpnResNeXt101UNet (full width and '
        'depth)', lambda **kw: models.CpnResNeXt101UNet(in_channels=3, **FLAGSHIP, **kw),
        tame=True)
    main_path(rng, card, errs, floor, 'phase 9: CpnResNet18FPN, 3 classes',
              lambda **kw: models.CpnResNet18FPN(in_channels=3, classes=3, **FLAGSHIP, **kw),
              tame=True, runs=(('bf16', torch.bfloat16, 4),))
    phase_tiled_flagship(card)
    phase_train_card_vs_cpu()
    launches_train, trainer, fixed = phase_train(card, errs, floor)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, 'last.ckpt')
        phase_checkpoints(rng, card, trainer, fixed, ckpt)
        launches_validate, val_ref = phase_validate(card, fixed, ckpt, errs, floor)
    launches_zoo = phase_zoo(rng, card, errs, floor)
    launches_cli, cli_ref = phase_cli(rng, card, errs, floor)
    launches_heads = phase_heads(rng, card, errs, floor)
    refs = {k: v for ref in (tiles_ref, val_ref, cli_ref) for k, v in ref.items() if k != 'inputs'}
    refs['inputs'] = {k: v for ref in (tiles_ref, val_ref, cli_ref)
                      for k, v in ref['inputs'].items()}
    launches_ddp = phase_ddp(card, errs, refs)
    launches_demo = phase_demo_binary(card, errs, floor)
    phase_demo_multiclass(card)
    launches_mamba = phase_mamba(rng, card, errs, floor)
    launches_utils = phase_utils(rng, card, errs, floor)
    phase_volumes(card)
    launches_encoder_heads = phase_encoder_heads(rng, card, errs, floor)
    phase_blocks(card)
    imported = {'jax', 'celldetection_tpu', 'cv2', 'skimage', 'msgpack', 'flax', 'h5py',
                'pandas', 'imageio', 'tifffile', 'PIL', 'yaml', 'matplotlib',
                'tensorboard'} & set(sys.modules)
    check(not imported, f'{sorted(imported)} imported')
    print(f'total {time.perf_counter() - t_start:.1f} s', flush=True)
    record = {'kernels': [{
        'name': name, 'route': 'cuda', 'source': f'celldetection_tpu_torch/csrc/{SOURCES[name]}',
        'replaces': 'celldetection_tpu/kernels/nms_pallas.py:59',
        'launches': launches[name], 'launches_tiled': launches_tiled[name],
        'launches_resnet': launches_resnet[name], 'launches_train': launches_train[name],
        'launches_validate': launches_validate[name], 'launches_zoo': launches_zoo[name],
        'launches_cli': launches_cli[name], 'launches_heads': launches_heads[name],
        'launches_ddp': launches_ddp[name], 'launches_demo': launches_demo[name],
        'launches_mamba': launches_mamba[name], 'launches_utils': launches_utils[name],
        'launches_encoder_heads': launches_encoder_heads[name],
        'max_abs_err': errs[name],
        'ms': rec[name]['ms'], 'plain_ms': rec[name]['plain_ms'],
        'bound_ms': rec[name]['bound_ms'], 'bound_by': rec[name]['bound_by'],
        'library_ms': None} for name in SOURCES]}
    # the heads' conv kernel, at the flagship's fused heads (phase 9), with
    # every shape of phases 5 and 9 under 'shapes'
    heads, heads_resnet = rec['head_conv'], rec_resnet['head_conv']
    shapes = heads['shapes'] + heads_resnet['shapes']
    top = max(heads_resnet['shapes'], key=lambda r: r['bound_ms'])
    record['kernels'].append({
        'name': 'head_conv', 'route': 'cuda', 'source': 'celldetection_tpu_torch/csrc/head_conv.cu',
        'replaces': None, 'launches': heads['launches'],
        'launches_resnet': heads_resnet['launches'],
        'max_diff_over_tol': max(r['max_diff_over_tol'] for r in shapes),
        **{key: top[key] for key in ('input', 'weight', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
                                     'library_ms')},
        'shapes': shapes})
    check(all(k[key] > 0. for k in record['kernels'] for key in ('ms', 'plain_ms', 'bound_ms')),
          f'a kernel lacks a measured time: {record}')
    print(card, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
