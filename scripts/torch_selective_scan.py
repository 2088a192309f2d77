#!/usr/bin/env python3
"""Time the Mamba scan's fused kernel on one CUDA card, beside its bound and the torch scans.

``celldetection_tpu_torch/kernels/selective_scan.py: selective_scan_kernel``
runs ``models/mamba.py: selective_scan`` in one fused pass whose states stay
in registers (``csrc/selective_scan.cu``). At the Mamba CPN's four stage
shapes on a 1024^2 tile (batch 1, d_state 16, expand 2, Δ rank 'auto':
65,536 x 512, 16,384 x 1024, 4096 x 2048 and 1024 x 4096 tokens x channels),
on operands laid out as ``Mamba.forward`` passes them (u a transposed view of
the convolution's ``[B, D, L]`` output, B and C column slices of ``x_proj``'s
output), it times with CUDA events:

* ``kernel_ms``: the kernel (median of 5 windows of 20 calls);
* ``bound_ms``: the least time of a fused scan, the bytes of
  ``h100_bench/layer_metrics/scan_roofline.tile.py: scan_bytes`` at the HBM's
  3.35 TB/s, and ``roofline``, its share of the kernel's time;
* ``torch_ms``: the torch scan the model ran before the kernel
  (``selective_scan_torch``: log-depth Hillis-Steele rounds);
* ``plain_ms``: the kernel's own chunked arithmetic in plain torch
  (``selective_scan_plain``), a check and no yardstick of speed.

It holds the kernel against ``selective_scan_plain`` at each shape (within
1e-5 + 1e-4 |plain|). Run from the repository root on a machine with a card:
``python3 scripts/torch_selective_scan.py [--out scan.json]``. Prints one JSON
line last; exits 1 when a comparison fails.
"""
import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from celldetection_tpu_torch.kernels import LAUNCHES  # noqa: E402
from celldetection_tpu_torch.kernels.selective_scan import (chunk_tokens,  # noqa: E402
                                                            selective_scan_kernel,
                                                            selective_scan_library,
                                                            selective_scan_plain)
from celldetection_tpu_torch.models.mamba import selective_scan_torch  # noqa: E402
from h100_bench import roofline  # noqa: E402

STAGES = ((65536, 512), (16384, 1024), (4096, 2048), (1024, 4096))   # tokens, d_inner
N_STATE = 16


def scan_bytes():
    spec = importlib.util.spec_from_file_location(
        'scan_roofline', os.path.join(ROOT, 'h100_bench', 'layer_metrics', 'scan_roofline.tile.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.scan_bytes


def operands(tokens, d_inner, seed=0):
    """As ``Mamba.forward`` passes them at batch 1, with the weights' scales of
    the Mamba CPN at its initialisation (A_log = log(1 .. 16), D = 1, Δ in
    [1e-3, 1e-1])."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    rank = -(-d_inner // 2 // 16)
    u = torch.randn(1, d_inner, tokens, device='cuda', generator=g).transpose(1, 2)
    proj = torch.randn(1, tokens, rank + 2 * N_STATE, device='cuda', generator=g)
    _, B, C = proj.split([rank, N_STATE, N_STATE], -1)
    delta = torch.exp(torch.rand(1, tokens, d_inner, device='cuda', generator=g) * 4.605 - 6.908)
    A = -torch.arange(1, N_STATE + 1, device='cuda', dtype=torch.float32).expand(d_inner, -1)
    return u, delta, A.contiguous(), B, C, torch.ones(d_inner, device='cuda')


def cuda_ms(fn, iters, windows=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def stage(tokens, d_inner, bytes_of):
    args = operands(tokens, d_inner)
    with torch.no_grad():
        got = selective_scan_kernel(*args)
        want = selective_scan_plain(*args)
        err = float(((got - want).abs() / (1e-5 + 1e-4 * want.abs())).max())
        del got, want
        kernel = cuda_ms(lambda: selective_scan_kernel(*args), 20)
        torch_ms = cuda_ms(lambda: selective_scan_torch(*args), 2, windows=3)
        plain = cuda_ms(lambda: selective_scan_plain(*args), 1, windows=3)
    bound = bytes_of(1, tokens, d_inner, N_STATE, 4) / roofline.HBM_BYTES_PER_S * 1e3
    return dict(tokens=tokens, d_inner=d_inner, chunk=chunk_tokens(1, tokens, d_inner),
                kernel_ms=kernel, bound_ms=bound, roofline=bound / kernel, torch_ms=torch_ms,
                plain_ms=plain, err_over_tol=err, ok=err <= 1.)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--out', help='also write the JSON here')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('torch_selective_scan: no CUDA device is available', file=sys.stderr)
        return 1
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True).stdout.strip().splitlines()
    built = selective_scan_library()
    print(f'card: {card[:1]}; torch {torch.__version__}; CUDA {torch.version.cuda}')
    print(f'build: {built.build_seconds:.1f} s; ptxas:')
    print('\n'.join(line for line in built.log.splitlines()
                    if 'registers' in line or 'spill' in line or 'Compiling' in line))
    bytes_of = scan_bytes()
    rows = []
    for tokens, d_inner in STAGES:
        rows.append(stage(tokens, d_inner, bytes_of))
        print(f'stage {json.dumps(rows[-1])}', flush=True)
        torch.cuda.empty_cache()
    total = {k: sum(r[k] for r in rows) for k in ('kernel_ms', 'bound_ms', 'torch_ms', 'plain_ms')}
    result = dict(card=card[:1], torch=torch.__version__, build_s=built.build_seconds,
                  stages=rows, total=total, roofline=total['bound_ms'] / total['kernel_ms'],
                  launches=LAUNCHES['cdt_selective_scan'], ok=all(r['ok'] for r in rows))
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            f.write(line + '\n')
    print(line)
    return 0 if result['ok'] else 1


if __name__ == '__main__':
    sys.exit(main())
