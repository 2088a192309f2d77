#!/usr/bin/env python3
"""Where the resolve's time per block goes: ``nms_resolve`` alone, on one card.

``csrc/nms_resolve.cu`` walks an image's 64-box blocks one after another, so
its time is about (blocks) x (time per step). This script times the kernel
alone (CUDA events, warmed up, the bits made once beforehand) on one image of
N boxes whose blocks do less and less work:

- ``invalid``: no valid box; a step stages the block and finds nothing live;
- ``apart``: every box valid and apart from all others (a grid); every box is
  kept, with no later word to OR;
- ``crowded``: random boxes at the density of ``chip_smoke.py``'s phase 3
  (16,384 boxes on 800^2), t=0.5: kept rows OR their later words.

At N = 64 (one block) the time is the launch and the fixed cost; the slope
between N = 64 and the largest N is the time per step. Then one launch of the
instrumented build (``resolve_library(trace=True)``, the same source built
with ``-DCDT_NMS_TRACE``) splits CTA 0's walk into its phases
(``csrc/nms_resolve.cu: Phase``), in SM clock cycles: for warp 0, which
resolves the blocks, and for the other warps, which stage and OR beside it.
``setup`` and ``finish`` are per launch, ``wait``, ``work`` and ``tail`` per
block; ``rounds`` is warp 0's ballot rounds per block. The clock reads cost
cycles of their own, so the instrumented walk is a little slower than the
timed one. Prints one JSON line per (inputs, N), with the SM clock that
``nvidia-smi`` reads after the instrumented launch.

Run from the repository root on a machine with a card:
``python3 scripts/torch_nms_resolve_steps.py``. Needs torch built for CUDA,
``nvcc`` and ``nvidia-smi``.
"""
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from celldetection_tpu_torch.kernels.build import launch  # noqa: E402
from celldetection_tpu_torch.kernels.nms import (_ptr, band_plan, large_layout,  # noqa: E402
                                                 nms_bits_count, nms_bits_fill, nms_resolve,
                                                 resolve_library, slots_layout)
from celldetection_tpu_torch.ops.boxes import sort_by_score  # noqa: E402

SIZES = (64, 16384, 262144)
PHASES = ('setup', 'wait', 'work', 'tail', 'finish')    # csrc/nms_resolve.cu: Phase


def boxes_of(kind, n, rng):
    if kind == 'apart':                                 # 8 px boxes on a 10 px grid
        side = int(np.ceil(np.sqrt(n)))
        x, y = np.divmod(np.arange(n), side)
        corners = np.stack([10. * x, 10. * y], -1)
        boxes = np.concatenate([corners, corners + 8.], -1)
    else:                                               # crowded (and all invalid)
        centers = rng.rand(n, 2) * 800. * np.sqrt(n / 16384)
        sizes = rng.rand(n, 2) * 20 + 2
        boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], -1)
    valid = np.full(n, kind != 'invalid')
    return boxes[None].astype(np.float32), rng.rand(1, n).astype(np.float32), valid[None]


def smi(query):
    return subprocess.run(['nvidia-smi', f'--query-gpu={query}', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def phases(traced, v, diag, nxt, pairs, start, base, keep, r0, r1):
    """One launch of the instrumented resolve (the arguments of kernels.nms.nms_resolve):
    CTA 0's clock cycles by phase for warp 0 and the other warps, and its rounds."""
    launch(traced, 'cdt_nms_resolve', v.device, diag.data_ptr(), _ptr(nxt), pairs.data_ptr(),
           _ptr(start), base, 0, keep.data_ptr(), v.shape[0], v.shape[1], r0, r1,
           int(large_layout(v.shape[1])))
    torch.cuda.synchronize()
    out = (ctypes.c_longlong * (2 * (len(PHASES) + 1)))()
    err = traced.lib.cdt_nms_resolve_phases(out)
    if err:
        raise RuntimeError(f'cdt_nms_resolve_phases: {traced.lib.cdt_cuda_error_string(err).decode()}')
    per_block = ('wait', 'work', 'tail')
    split = {who: {name: out[i * (len(PHASES) + 1) + k] / (r1 - r0 if name in per_block else 1)
                   for k, name in enumerate(PHASES)}
             for i, who in enumerate(('warp0', 'others'))}
    return split, out[len(PHASES)] / (r1 - r0)


def main():
    card = smi('name,power.limit')
    traced = resolve_library(trace=True)
    print('\n'.join(line for line in traced.log.splitlines()
                    if 'nms_resolve_kernel' in line or 'registers' in line or 'spill' in line),
          flush=True)
    rng = np.random.RandomState(0)
    for kind in ('invalid', 'apart', 'crowded'):
        for n in SIZES:
            boxes, scores, valid = (torch.from_numpy(a).cuda() for a in boxes_of(kind, n, rng))
            _, b, v = sort_by_score(boxes, scores, valid)
            slots = slots_layout(1, n)
            start, diag, flags, nxt = nms_bits_count(b, v, 0.5, packed=not slots)
            if start is not None:
                start.cumsum_(0)
            (r0, r1, base, size), = band_plan(start, 1, n)
            pairs = nms_bits_fill(b, v, 0.5, r0, r1, flags, start, base, size)
            keep = torch.empty_like(v)

            def resolve():
                nms_resolve(v, diag, nxt, pairs, start, base, None, keep, r0, r1)

            for _ in range(3):
                resolve()
            iters = 200 if n <= 16384 else 20
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            for _ in range(iters):
                resolve()
            ev[1].record()
            ev[1].synchronize()
            ms = ev[0].elapsed_time(ev[1]) / iters
            traced_keep = torch.empty_like(keep)
            cycles, rounds = phases(traced, v, diag, nxt, pairs, start, base, traced_keep, r0, r1)
            if not torch.equal(traced_keep, keep):
                raise RuntimeError(f'{kind} {n}: the instrumented resolve keeps other boxes')
            print(json.dumps({'card': card, 'inputs': kind, 'boxes': n, 'blocks': r1,
                              'layout': 'slots' if slots else 'packed',
                              'pairs': int(start[-1]) if start is not None else None,
                              'kept': int(keep.sum()), 'ms': ms,
                              'us_per_block': 1e3 * ms / r1, 'cycles': cycles,
                              'rounds_per_block': rounds, 'sm_clock': smi('clocks.sm')}),
                  flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
