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
     device (profiler), beside the bound, the plain version, the launches
     per call, the peak scratch and the launch floor;
  4. full-width CpnU22 at 256^2 on the card against the same model on the
     CPU, TF32 off;
  5. the main path, ``CPN.forward_padded`` of full-width CpnU22 (backbone,
     heads, decode, refinement, NMS kernel) on 1024^2 tiles, fp32 at batch 1
     and bf16 at batch 4: throughput, a profile of one step (top kernels and
     the slowest convolutions by input shape), peak memory, detections before
     and after NMS, the kernel launches of that run, and the NMS kernels
     held against their plain versions and timed on that run's boxes;
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
     fp32 at batch 1 and bf16 at batch 4, CpnDenseNet121UNet,
     CpnMobileNetV3LargeFPN and CpnResNet50MaNet in bf16 at batch 4 (the
     kernel launches of these runs are ``launches_zoo``);
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
     writer an input.

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
from celldetection_tpu_torch import kernels, models
from celldetection_tpu_torch.kernels import nms as knms
from celldetection_tpu_torch.kernels import nms_bits_count, nms_bits_fill, nms_resolve
from celldetection_tpu_torch.kernels.nms import (band_plan, bits_library, large_layout,
                                                 nms_sweep, resolve_library, slots_layout)
from celldetection_tpu_torch.ops.boxes import (BLOCK, _nms_sweep, _resolve_blocks,
                                               _suppression_counts, _suppression_matrix,
                                               _suppression_pairs, box_iou, nms_chunked,
                                               nms_padded, sort_by_score)
from celldetection_tpu_torch.data import collate_cpn_targets, contours2labels, cpn_targets_single
from celldetection_tpu_torch.native import contours2labels_native, rasterize_library
from celldetection_tpu_torch.parallel.tiles import TiledInference, tile_image
from celldetection_tpu_torch.parallel.train import TrainState, make_train_step
from celldetection_tpu_torch.runtime.cpn_inference import infer_input, preprocess, tiled_models
from celldetection_tpu_torch.runtime.trainer import CPNTrainer
from celldetection_tpu_torch.util.config import conf2optimizer
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
# fp32 operations of one box-pair test (csrc/nms_bits.cu:suppresses): 4 min/max,
# 2 sub, 2 clamps, inter mul, union add and sub, thresh mul, select, compare.
PAIR_TEST_OPS = 14
# ... and of a pair whose boxes lie apart on an axis (csrc/nms_bits.cu:apart,
# the bits kernels' exact early-out): 4 compares.
APART_OPS = 4
SCRATCH_LIMIT = 256 * 2 ** 20   # bytes the NMS sweep may allocate at any phase-3 shape
# profiler names of the kernels' device functions (each in its two layouts' builds)
DEVICE_NAMES = (('nms_bits_kernel<false,', 'nms_bits_count'),
                ('nms_bits_kernel<true,', 'nms_bits_fill'),
                ('nms_resolve_kernel', 'nms_resolve'))
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


def device_ms(fn, calls, attempts=5):
    """Device time (ms) per launch of each NMS kernel over ``calls`` calls of
    ``fn``, from ``torch.profiler``, with its launches per call. A profiling
    session now and then records no device activity at all (late in a long
    run, several in a row); it is repeated after a pause, and None returned
    when no session saw every kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            for key, name in DEVICE_NAMES:
                if e.device_type == DeviceType.CUDA and key in e.key:
                    out[name] = (e.self_device_time_total / 1e3 / e.count, round(e.count / calls))
        if len(out) == len(DEVICE_NAMES):
            return out
        time.sleep(1.)
    return None


def launch_floor_ms():
    """Time per launch of an empty kernel on the current stream, back to back (CUDA events)."""
    lib = resolve_library().lib
    stream = torch.cuda.current_stream().cuda_stream
    return cuda_ms(lambda: lib.cdt_empty_launch(stream), 2000, warmup=100)


def time_sweep(label, b, v, keep, thresh, card, floor):
    """The sweep's time per call and per kernel at one shape, beside its bound."""
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
    dev = device_ms(lambda: nms_sweep(b, v, thresh), min(iters, 10))
    before = [k.launches for k in kernels.KERNELS]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    nms_sweep(b, v, thresh)
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated() - held
    per_call = sum(k.launches for k in kernels.KERNELS) - sum(before)
    bound_ms, bound_by, tests = nms_bound(b, v, keep, thresh)
    kernels_ms = 'not measured (no profiling session saw every kernel)' if dev is None else \
        ', '.join(f'{name} {dev[name][0]:.4f} ms x{dev[name][1]}' for _, name in DEVICE_NAMES)
    print(f'  [{card}] nms_sweep {label}: {ms:.4f} ms per call (median of 3 windows of {iters} '
          f'calls, {windows[0]:.4f}-{windows[2]:.4f}; CUDA events), '
          f'host {host_ms:.4f} ms per call (host clock, no synchronisation); on the device '
          f'{kernels_ms} (profiler); {per_call} kernel launches per call, '
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


def main_path(rng, card, errs, floor, title, build, tame=False,
              runs=(('fp32', None, 1), ('bf16', torch.bfloat16, 4)), score=1.):
    """Phases 5, 9 and 15: the model ``build(compute_dtype=...)`` makes on
    1024^2 tiles in each of ``runs`` (name, compute dtype, batch), with
    ``random_weights(tame, score)``."""
    print(f'== {title} on 1024^2 tiles', flush=True)
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
        x = torch.from_numpy(rng.rand(batch, TILE, TILE, 3).astype(np.float32)).cuda()
        # score threshold from this configuration's own scores: at least
        # 3072 foreground pixels per image, so the NMS sees 2048 valid boxes
        # (with more than two classes the classes are the argmax and the
        # threshold plays no part)
        probs = torch.sigmoid(m.forward_padded(x, nms=False)['dense_scores'].float())
        if m.uncertainty_head:
            probs = probs * certain_half(m, x).view_as(probs)
        configs.append((name, m, x, threshold_above(probs, 3072)))

    for k in kernels.KERNELS:          # the main path's run: counts from 0
        k.launches = 0
    runs = []
    for name, m, x, thresh in configs:
        before = sum(k.launches for k in kernels.KERNELS)
        pre = m.forward_padded(x, score_thresh=thresh, nms=False)
        out = m.forward_padded(x, score_thresh=thresh)
        res = m(x, score_thresh=thresh)               # the user API: ragged per-image results
        torch.cuda.synchronize()
        runs.append((name, m, x, thresh, pre, out, res,
                     sum(k.launches for k in kernels.KERNELS) - before))
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    print(f'  kernel launches in the main path run: {launches}', flush=True)
    check(all(n > 0 for n in launches.values()), 'a kernel of the path was never launched')

    kernel_rec = {}
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
                ms_k = None if dev is None else dev[name_k][0]
                kernel_rec[name_k] = dict(ms=ms_k, plain_ms=cuda_ms(fn, 2, warmup=1),
                                          bound_ms=bounds[name_k][0], bound_by=bounds[name_k][1])
                print(f'  [{card}] {name_k} B={batch} N=2048 ({name} main path, '
                      f'{"slots" if slots else "packed"} layout): '
                      f'{"not measured" if ms_k is None else f"{ms_k:.4f} ms"} on the device, plain '
                      f'{kernel_rec[name_k]["plain_ms"]:.3f} ms, bound '
                      f'{bounds[name_k][0]:.6f} ms ({bounds[name_k][1]})', flush=True)
    return launches, kernel_rec


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

    for k in kernels.KERNELS:          # the tiled path's run: counts from 0
        k.launches = 0
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
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
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
    drawn with numpy, as ``data.random_geometric_objects`` draws them in the
    JAX package (which needs cv2): up to ``num`` non-overlapping disks of
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
    for k in kernels.KERNELS:
        k.launches = 0


def read_launches():
    torch.cuda.synchronize()
    return {k.__name__: k.launches for k in kernels.KERNELS}


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
    pretrained load; then the main path of four zoo models on 1024^2 tiles.
    Returns the NMS kernels' launches in phase 15's runs."""
    for name, factors in ZOO_CHECK.items():
        phase_card_vs_cpu(rng, f'phase 14: {name} (full width and depth)',
                          lambda name=name, **kw: models.get_cpn(name)(3, **FLAGSHIP, **kw),
                          tame=True, **factors)
    phase_pretrained(rng)
    launches = {k.__name__: 0 for k in kernels.KERNELS}
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
        built = list(pool.map(lambda load: load(), (bits_library, resolve_library)))
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
    check(all(rec[name]['ms'] is not None for name in SOURCES),
          'the profiler never saw the main path\'s NMS kernels')
    phase_tiled_card_vs_cpu(rng)
    launches_tiled, tiles_ref = phase_gigapixel(card, floor)
    phase_card_vs_cpu(rng, 'phase 8: CpnResNeXt101UNet (full width and depth)',
                      lambda **kw: models.CpnResNeXt101UNet(in_channels=3, **FLAGSHIP, **kw),
                      tame=True)
    # K above the 64^2 score map's pixels: every foreground pixel is selected
    phase_card_vs_cpu(rng, 'phase 8: CpnResNet18FPN, 3 classes',
                      lambda **kw: models.CpnResNet18FPN(in_channels=3, classes=3,
                                                         max_detections=4096, **kw), tame=True)
    launches_resnet, _ = main_path(
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
    imported = {'jax', 'celldetection_tpu', 'cv2', 'skimage', 'msgpack', 'flax', 'h5py',
                'pandas', 'imageio', 'tifffile', 'PIL'} & set(sys.modules)
    check(not imported, f'{sorted(imported)} imported')
    print(f'total {time.perf_counter() - t_start:.1f} s', flush=True)
    record = {'kernels': [{
        'name': name, 'route': 'cuda', 'source': f'celldetection_tpu_torch/csrc/{SOURCES[name]}',
        'replaces': 'celldetection_tpu/kernels/nms_pallas.py:59',
        'launches': launches[name], 'launches_tiled': launches_tiled[name],
        'launches_resnet': launches_resnet[name], 'launches_train': launches_train[name],
        'launches_validate': launches_validate[name], 'launches_zoo': launches_zoo[name],
        'launches_cli': launches_cli[name], 'launches_heads': launches_heads[name],
        'launches_ddp': launches_ddp[name],
        'max_abs_err': errs[name],
        'ms': rec[name]['ms'], 'plain_ms': rec[name]['plain_ms'],
        'bound_ms': rec[name]['bound_ms'], 'bound_by': rec[name]['bound_by'],
        'library_ms': None} for name in SOURCES]}
    print(card, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
