#!/usr/bin/env python3
"""Time CpnU22's fused contour-head convolution on one CUDA card, in variants.

On 1024^2 tiles the score, location and Fourier heads of CpnU22 read the same
128-channel map at stride 2 with 7x7 kernels. ``CPNCore`` runs their conv0s
as one convolution with 3 x 128 = 384 output channels
(``celldetection_tpu_torch/models/commons.py: fused_head_conv``). This script
times that convolution with cuDNN's default (heuristic) algorithm choice,
against the same work as three 128-channel convolutions, with
``cudnn.benchmark`` (in a fresh process, because PyTorch caches the first
plan it finds for a shape), and in fp32 (TF32), each with CUDA events.

Run from the repository root on a machine with a card:
``python3 scripts/torch_head_conv.py``. Needs torch built for CUDA only.
"""
import subprocess
import sys

import torch
import torch.nn.functional as F

BATCH, CHANNELS, SIDE, HEADS, KERNEL = 4, 128, 512, 3, 7


def cuda_ms(fn, iters=10):
    for _ in range(2):
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


def operands(dtype, batch=BATCH):
    gen = torch.Generator(device='cuda').manual_seed(0)
    x = torch.randn(batch, CHANNELS, SIDE, SIDE, device='cuda', dtype=dtype, generator=gen)
    w = torch.randn(HEADS * CHANNELS, CHANNELS, KERNEL, KERNEL, device='cuda', dtype=dtype,
                    generator=gen) * 0.01
    b = torch.zeros(HEADS * CHANNELS, device='cuda', dtype=dtype)
    return x.contiguous(memory_format=torch.channels_last), w, b


def main():
    if not torch.cuda.is_available():
        print('torch_head_conv: no CUDA device is available', file=sys.stderr)
        return 1
    pad = KERNEL // 2
    if sys.argv[1:] == ['--benchmark']:
        torch.backends.cudnn.benchmark = True
        x, w, b = operands(torch.bfloat16)
        print(f'bf16 fused, cudnn.benchmark: {cuda_ms(lambda: F.conv2d(x, w, b, padding=pad)):.3f} ms')
        return 0
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f'{card}; torch {torch.__version__}; input [{BATCH}, {CHANNELS}, {SIDE}, {SIDE}] '
          f'channels-last, weight [{HEADS * CHANNELS}, {CHANNELS}, {KERNEL}, {KERNEL}]')
    x, w, b = operands(torch.bfloat16)
    print(f'bf16 fused (384 out): {cuda_ms(lambda: F.conv2d(x, w, b, padding=pad)):.3f} ms')
    parts = [w[i * CHANNELS:(i + 1) * CHANNELS].contiguous() for i in range(HEADS)]
    three = cuda_ms(lambda: [F.conv2d(x, p, b[:CHANNELS], padding=pad) for p in parts])
    print(f'bf16 as three convolutions (128 out each): {three:.3f} ms')
    w_cl = w.contiguous(memory_format=torch.channels_last)
    print(f'bf16 fused, channels-last weight: '
          f'{cuda_ms(lambda: F.conv2d(x, w_cl, b, padding=pad)):.3f} ms')
    x1 = x[:1].contiguous(memory_format=torch.channels_last)
    print(f'bf16 fused, batch 1: {cuda_ms(lambda: F.conv2d(x1, w, b, padding=pad)):.3f} ms')
    xf, wf, bf = (t.float() for t in (x, w, b))
    print(f'fp32 (TF32) fused: {cuda_ms(lambda: F.conv2d(xf, wf, bf, padding=pad)):.3f} ms')
    parts_f = [p.float() for p in parts]
    three_f = cuda_ms(lambda: [F.conv2d(xf, p, bf[:CHANNELS], padding=pad) for p in parts_f])
    print(f'fp32 (TF32) as three convolutions: {three_f:.3f} ms')
    out = subprocess.run([sys.executable, __file__, '--benchmark'], capture_output=True,
                         text=True, check=True)
    print(out.stdout.strip())
    return 0


if __name__ == '__main__':
    sys.exit(main())
