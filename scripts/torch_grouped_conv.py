#!/usr/bin/env python3
"""Time CpnResNeXt101UNet's grouped 3x3 convolutions on one CUDA card, in three forms.

ResNeXt101 (32x8d) runs a 3x3 convolution of 32 groups in every bottleneck
(``celldetection_tpu_torch/models/resnet.py: Bottleneck.conv2``). On a 1024^2
tile its four stages see 256^2, 128^2, 64^2 and 32^2 maps of 256, 512, 1024
and 2048 channels (8, 16, 32 and 64 channels a group). For each stage, at
batch 1 and 4, in fp32 (TF32, PyTorch's default for convolutions) and bf16,
channels-last, this script times with CUDA events:

* ``groups=32`` with cuDNN's default (heuristic) algorithm, the port's path;
* the same with ``cudnn.benchmark`` (in a fresh process, because PyTorch
  caches the first plan it finds for a shape);
* the block-diagonal dense rewrite of the JAX package's ``GroupedConv``
  (``celldetection_tpu/models/commons.py:153-200``): one ``groups=1``
  convolution whose weight is zero outside the diagonal blocks, 32 times the
  operations.

It mirrors ``scripts/torch_head_conv.py`` and ``scripts/bench_grouped_conv.py``
(the JAX package's TPU measurement of the same question). Run from the
repository root on a machine with a card: ``python3 scripts/torch_grouped_conv.py``.
Needs torch built for CUDA only; the port's main path is not changed by it.
"""
import subprocess
import sys

import torch
import torch.nn.functional as F

GROUPS = 32
# (side, channels) of each ResNeXt101 stage's grouped 3x3 conv on a 1024^2 tile
STAGES = ((256, 256), (128, 512), (64, 1024), (32, 2048))
BATCHES = (1, 4)
DTYPES = (('fp32 (TF32)', torch.float32), ('bf16', torch.bfloat16))


def cuda_ms(fn, iters=20):
    for _ in range(3):
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


def operands(batch, side, channels, dtype):
    gen = torch.Generator(device='cuda').manual_seed(0)
    x = torch.randn(batch, channels, side, side, device='cuda', generator=gen).to(dtype)
    w = (torch.randn(channels, channels // GROUPS, 3, 3, device='cuda', generator=gen)
         * 0.05).to(dtype)
    return x.contiguous(memory_format=torch.channels_last), w


def block_diagonal(w):
    """``[C, C / G, 3, 3]`` grouped weight → ``[C, C, 3, 3]`` dense, zero off the diagonal blocks."""
    c, cg = w.shape[:2]
    dense = w.new_zeros(c, c, 3, 3)
    for g in range(GROUPS):
        dense[g * cg:(g + 1) * cg, g * cg:(g + 1) * cg] = w[g * cg:(g + 1) * cg]
    return dense


def rows(benchmark):
    """(label, ms) of every shape, grouped; and dense where ``benchmark`` is off."""
    torch.backends.cudnn.benchmark = benchmark
    torch.backends.cudnn.allow_tf32 = True
    out = []
    for dname, dtype in DTYPES:
        for batch in BATCHES:
            for side, channels in STAGES:
                x, w = operands(batch, side, channels, dtype)
                label = f'{dname} batch {batch} [{batch}, {channels}, {side}, {side}]'
                ms = cuda_ms(lambda: F.conv2d(x, w, padding=1, groups=GROUPS))
                dense_ms = None
                if not benchmark:
                    wd = block_diagonal(w)
                    err = float((F.conv2d(x, wd, padding=1).float()
                                 - F.conv2d(x, w, padding=1, groups=GROUPS).float()).abs().max())
                    dense_ms = cuda_ms(lambda: F.conv2d(x, wd, padding=1))
                out.append((label, ms, dense_ms, None if benchmark else err))
    return out


def main():
    if not torch.cuda.is_available():
        print('torch_grouped_conv: no CUDA device is available', file=sys.stderr)
        return 1
    if sys.argv[1:] == ['--benchmark']:
        for label, ms, _, _ in rows(True):
            print(f'{label}\t{ms:.4f}')
        return 0
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f'{card}; torch {torch.__version__}; 3x3 convolutions of {GROUPS} groups, '
          f'channels-last input, ms per call (CUDA events, mean of 20)')
    bench = subprocess.run([sys.executable, __file__, '--benchmark'], capture_output=True,
                           text=True, check=True).stdout.strip().splitlines()
    bench = dict(line.split('\t') for line in bench)
    print('shape | groups=32 | groups=32, cudnn.benchmark | block-diagonal dense | '
          'max |dense - grouped|')
    for label, ms, dense_ms, err in rows(False):
        print(f'{label} | {ms:.4f} | {float(bench[label]):.4f} | {dense_ms:.4f} | {err:.2e}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
