#!/usr/bin/env python3
"""The CPN heads' convolution kernel on one CUDA card: against its plain version, and its time.

``celldetection_tpu_torch/kernels/head_conv.py: head_conv_kernel`` runs the
heads' bf16 K x K "same" convolution as an implicit GEMM on the tensor cores
(``csrc/head_conv.cu``). This script holds it against
``head_conv_plain`` (fp32 sums of the bf16 products, TF32 off, one rounding
to bf16) at the shapes the port runs on 1024^2 tiles, batch 4:

* the flagship CpnResNeXt101UNet's fused score, location and Fourier heads,
  ``[4, 256, 512, 512]`` by ``[768, 256, 7, 7]``;
* CpnU22's fused heads, ``[4, 128, 512, 512]`` by ``[384, 128, 7, 7]``;
* the refinement head at full resolution, ``[4, 64, 1024, 1024]`` by
  ``[64, 64, 7, 7]``;
* CpnConvNeXtLargeUNet's fused heads, ``[4, 192, 512, 512]`` by
  ``[576, 192, 7, 7]``, and its refinement head, ``[4, 192, 1024, 1024]`` by
  ``[192, 192, 7, 7]`` (both on tiles of 64 output channels);

and at a ragged border, batch 1 and an all-zero input. A value passes where
it lies within one bf16 ulp of the plain one (two halves of an ulp: both
round once, after sums in different orders) plus the error bound of fp32
sums. At the five main shapes it times, with CUDA events: the kernel
(``kernel_ms``), its bound (the FLOPs at the 989 TFLOP/s dense bf16 peak,
``bound_ms``), the plain version (``plain_ms``) and, as yardsticks the port
never calls, cuDNN's bf16 ``F.conv2d`` with its heuristic choice
(``library_ms``) and under ``cudnn.benchmark`` (``benchmark_ms``, in a fresh
process, since PyTorch keeps the first plan it finds for a shape).

Run from the repository root on a machine with a card:
``python3 scripts/torch_head_conv.py [--out head_conv.json]``.
Prints one JSON line last; exits 1 when a comparison fails.
"""
import argparse
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from celldetection_tpu_torch.kernels import LAUNCHES  # noqa: E402
from celldetection_tpu_torch.kernels.head_conv import (head_conv_kernel,  # noqa: E402
                                                       head_conv_library, head_conv_plain)

PEAK_BF16 = 989e12    # dense bf16 FLOP/s of an H100 SXM at 700 W (NVIDIA's data sheet)
SHAPES = {            # name: (batch, cin, cout, k, height, width)
    'flagship_fused': (4, 256, 768, 7, 512, 512),
    'u22_fused': (4, 128, 384, 7, 512, 512),
    'refinement': (4, 64, 64, 7, 1024, 1024),
    'convnext_large_fused': (4, 192, 576, 7, 512, 512),
    'convnext_large_refinement': (4, 192, 192, 7, 1024, 1024),
}
EDGES = {
    'ragged_border': (2, 256, 768, 7, 37, 53),
    'batch_1': (1, 128, 384, 7, 100, 131),
    'zero_input': (1, 256, 768, 7, 64, 64),
}


def operands(shape, seed=0, zero=False):
    batch, cin, cout, k, h, w = shape
    gen = torch.Generator(device='cuda').manual_seed(seed)
    x = torch.randn(batch, cin, h, w, device='cuda', generator=gen).bfloat16()
    if zero:
        x.zero_()
    wt = (torch.randn(cout, cin, k, k, device='cuda', generator=gen)
          / (cin * k * k) ** 0.5).bfloat16()
    b = torch.randn(cout, device='cuda', generator=gen).bfloat16()
    return x.contiguous(memory_format=torch.channels_last), wt, b


def cuda_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def flops(shape):
    batch, cin, cout, k, h, w = shape
    return 2. * batch * h * w * cout * cin * k * k


def compare(shape, zero=False):
    """The kernel against the plain version: within one ulp plus the sums' error."""
    batch, cin, cout, k, h, w = shape
    x, wt, b = operands(shape, zero=zero)
    got = head_conv_kernel(x, wt, b)
    torch.cuda.synchronize()
    want = head_conv_plain(x, wt, b)
    diff = (got.float() - want.float()).abs()
    scale = want.float().abs()
    tol = 2. ** -7 * scale + cin * k * k * 2. ** -23 * scale.max()
    row = dict(shape=list(shape), ok=bool((diff <= tol).all()),
               exact_share=float((diff == 0).float().mean()),
               max_diff_over_tol=float((diff / tol.clamp_min(1e-30)).max()),
               channels_last=got.is_contiguous(memory_format=torch.channels_last))
    if zero:
        row['ok'] &= bool(torch.equal(got, b[None, :, None, None].expand_as(got)))
    return row


def timings(shape):
    x, wt, b = operands(shape)
    pad = shape[3] // 2
    kernel = cuda_ms(lambda: head_conv_kernel(x, wt, b), 10)
    plain = cuda_ms(lambda: head_conv_plain(x, wt, b), 2)
    library = cuda_ms(lambda: F.conv2d(x, wt, b, padding=pad), 3)
    bound = flops(shape) / PEAK_BF16 * 1e3
    return dict(kernel_ms=kernel, bound_ms=bound, plain_ms=plain, library_ms=library,
                kernel_tflops=flops(shape) / kernel / 1e9, peak_share=bound / kernel)


def benchmark_child():
    torch.backends.cudnn.benchmark = True
    out = {}
    for name, shape in SHAPES.items():
        x, wt, b = operands(shape)
        out[name] = cuda_ms(lambda: F.conv2d(x, wt, b, padding=shape[3] // 2), 3)
    print(json.dumps(out))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--out', help='also write the JSON here')
    parser.add_argument('--benchmark-child', action='store_true', help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('torch_head_conv: no CUDA device is available', file=sys.stderr)
        return 1
    if args.benchmark_child:
        benchmark_child()
        return 0
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True).stdout.strip().splitlines()
    built = head_conv_library()
    print(f'card: {card[:1]}; torch {torch.__version__}; CUDA {torch.version.cuda}')
    print(f'build: {built.build_seconds:.1f} s; ptxas:')
    print('\n'.join(line for line in built.log.splitlines()
                    if 'registers' in line or 'spill' in line or 'Compiling' in line))
    result = dict(card=card[:1], torch=torch.__version__, build_s=built.build_seconds,
                  checks={}, timings={})
    for name, shape in {**EDGES, **SHAPES}.items():
        result['checks'][name] = row = compare(shape, zero=name == 'zero_input')
        print(f'check {name}: {json.dumps(row)}', flush=True)
    if all(r['ok'] for r in result['checks'].values()):
        for name, shape in SHAPES.items():
            result['timings'][name] = row = timings(shape)
            print(f'time {name}: {json.dumps(row)}', flush=True)
        child = subprocess.run([sys.executable, __file__, '--benchmark-child'],
                               capture_output=True, text=True)
        if child.returncode == 0:
            for name, ms in json.loads(child.stdout.strip().splitlines()[-1]).items():
                result['timings'][name]['benchmark_ms'] = ms
        else:
            result['benchmark_error'] = child.stderr[-2000:]
    result['launches'] = LAUNCHES['cdt_head_conv']
    result['ok'] = all(r['ok'] for r in result['checks'].values())
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            f.write(line + '\n')
    print(line)
    return 0 if result['ok'] else 1


if __name__ == '__main__':
    sys.exit(main())
