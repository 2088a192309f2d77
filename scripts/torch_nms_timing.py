#!/usr/bin/env python3
"""Time the port's greedy NMS (``kernels.nms.nms_sweep``) of one or more checkouts.

Each checkout runs in a process of its own, in the order given, so that two
versions of the kernels can be compared on one card within one call (parent,
change, change, parent). Every process makes the same crowded boxes from
numpy seeds and times ``nms_sweep`` on them with CUDA events, warmed up, at
the shapes of ``chip_smoke.py``'s phase 3 that stitch-scale NMS needs:

- B=4 x N=2048 at t=0.2 and 0.5, B=1 x N=2048 (the per-image main path);
- B=1 x N=16,384 (the capacity retry's largest image);
- B=56 x N=16,384 (``nms_chunked``'s per-chunk pass on a 16,384^2 mosaic);
- B=1 x N=262,144 (stitch scale), all at the density of the 16,384 case;
- B=4 and B=1 x N=2048 at t=0.2 boxes clustered as the main path's are:
  2048 proposals around 57 cells of one 1024^2 tile, so that nearly every
  64-bit word of the suppression bits is set.

For each shape it prints one JSON line with the mean ms per call, the number
of calls timed, the boxes kept and a digest of the keep mask, so that the
masks of two checkouts can be compared.

Run from the repository root on a machine with a card:
``python3 scripts/torch_nms_timing.py [CHECKOUT[:packed] ...]`` (default:
this one). ``CHECKOUT:packed`` times that checkout's kernels in the packed
layout at every shape, also where ``nms_sweep`` takes the slots layout. Needs torch built for CUDA, ``nvcc`` and ``nvidia-smi``.
"""
import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (label, batch, boxes per image, extent of the box centres, threshold)
SHAPES = (('B=4 N=2048 t=0.2', 4, 2048, 200., 0.2),
          ('B=4 N=2048 t=0.5', 4, 2048, 200., 0.5),
          ('B=1 N=2048 t=0.5', 1, 2048, 200., 0.5),
          ('B=1 N=16384 t=0.5', 1, 16384, 800., 0.5),
          ('B=56 N=16384 t=0.5', 56, 16384, 800., 0.5),
          ('B=1 N=262144 t=0.5', 1, 262144, 3200., 0.5),
          ('B=4 N=2048 cells t=0.2', 4, 2048, None, 0.2),
          ('B=1 N=2048 cells t=0.2', 1, 2048, None, 0.2))
TARGET_S = 0.5      # time spent timing one shape, at most 50 calls


def crowded_boxes(seed, batch, n, extent, invalid=0.05):
    import numpy as np
    rng = np.random.RandomState(seed)
    if extent is None:                                 # clustered: 57 cells on a 1024^2 tile
        cells = rng.rand(batch, 57, 4) * [1024., 1024., 30., 30.] + [0., 0., 10., 10.]
        pick = np.take_along_axis(cells, rng.randint(0, 57, (batch, n, 1)), 1)
        centers = pick[..., :2] + rng.randn(batch, n, 2) * 2
        sizes = pick[..., 2:] * (1 + rng.randn(batch, n, 2) * 0.1)
        boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], -1).astype(np.float32)
        return boxes, rng.rand(batch, n).astype(np.float32), np.ones((batch, n), bool)
    centers = rng.rand(batch, n, 2) * extent
    sizes = rng.rand(batch, n, 2) * 20 + 2
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], -1).astype(np.float32)
    return boxes, rng.rand(batch, n).astype(np.float32), rng.rand(batch, n) > invalid


def time_checkout(root, packed=False):
    import torch
    sys.path.insert(0, root)
    from celldetection_tpu_torch.kernels.nms import nms_sweep
    from celldetection_tpu_torch.ops.boxes import sort_by_score
    if packed:
        from celldetection_tpu_torch.kernels.nms import (band_plan, nms_bits_count,
                                                         nms_bits_fill, nms_resolve)

        def nms_sweep(b, v, t):  # kernels.nms.bits_sweep, with the packed layout at every size
            start, diag, flags, nxt = nms_bits_count(b, v, t, packed=True)
            start.cumsum_(0)
            bands = band_plan(start, *v.shape)
            keep = torch.empty_like(v)
            removed = (torch.empty(v.shape[0], -(-v.shape[1] // 64), dtype=torch.int64,
                                   device=v.device) if len(bands) > 1 else None)
            for r0, r1, base, size in bands:
                pairs = nms_bits_fill(b, v, t, r0, r1, flags, start, base, size)
                nms_resolve(v, diag, nxt, pairs, start, base, removed, keep, r0, r1)
            return keep

    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    for seed, (label, batch, n, extent, t) in enumerate(SHAPES):
        arrays = crowded_boxes(seed, batch, n, extent)
        boxes, scores, valid = (torch.from_numpy(a).cuda() for a in arrays)
        _, b, v = sort_by_score(boxes, scores, valid)
        keep = nms_sweep(b, v, t)                      # warm-up; builds the kernels
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nms_sweep(b, v, t)
        torch.cuda.synchronize()
        iters = max(1, min(50, int(TARGET_S / (time.perf_counter() - t0))))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            nms_sweep(b, v, t)
        end.record()
        end.synchronize()
        digest = hashlib.sha1(keep.cpu().numpy().tobytes()).hexdigest()[:16]
        print(json.dumps({'checkout': root, 'packed': packed, 'card': card, 'shape': label,
                          'ms': start.elapsed_time(end) / iters, 'calls': iters,
                          'kept': int(keep.sum()), 'valid': int(v.sum()), 'keep_sha1': digest}),
              flush=True)


def main(argv):
    if argv[:1] == ['--one']:
        time_checkout(os.path.abspath(argv[1]), argv[2:] == ['packed'])
        return 0
    for arg in argv or [HERE]:
        root, _, layout = arg.partition(':')
        root = os.path.abspath(root)
        subprocess.run([sys.executable, os.path.abspath(__file__), '--one', root]
                       + ([layout] if layout else []), check=True, cwd=root)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
