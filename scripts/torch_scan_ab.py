#!/usr/bin/env python3
"""Time the Mamba ``selective_scan`` on one CUDA card: the port's scan against an out-of-place one.

``celldetection_tpu_torch/models/mamba.py: selective_scan_torch`` (the scan
``selective_scan`` runs for bf16, for training and on the CPU; fp32 inference
on the card takes the fused kernel, which ``scripts/torch_selective_scan.py``
times) is a log-depth Hillis-Steele scan in plain torch over ``[B, L, D, N]``
tensors, each round written into the other of two buffers, with a
hand-written backward (the same scan from the end). The out-of-place design
below (kept here only to time against) needs no backward of its own: each
round is
``x = addcmul(x, gain, pad(x[:, :-step]))`` and
``gain = gain * pad(gain[:, :-step], value=1)``, and autograd keeps every
round's tensors.

The shapes are those of ``chip_smoke.py`` phase 19c: CpnResNet50UNet with a
``MambaLayer`` after each encoder stage on a 512^2 tile, ``d_state`` 16 and
``expand`` 2, so the four stages scan ``L`` = 128^2, 64^2, 32^2, 16^2 tokens
of ``D`` = 512, 1024, 2048, 4096 channels. CUDA events time the forward
(fp32 at batch 1, bf16 at batch 4) and the forward with the backward of
``y.square().sum()`` (fp32 at batch 1), in the order port, out of place, out
of place, port (the median of 5 calls each time; each design's lower median
is reported), with the allocator's peak above the inputs. The forwards must
be equal bit for bit; the gradients' largest difference is printed,
relative to each gradient's largest magnitude. Run from the repository root
on a machine with a card: ``python3 scripts/torch_scan_ab.py``.
"""
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from celldetection_tpu_torch.models.mamba import selective_scan_torch  # noqa: E402

N_STATE = 16
STAGES = ((128 * 128, 512), (64 * 64, 1024), (32 * 32, 2048), (16 * 16, 4096))
RUNS = (('fp32', torch.float32, 1, False), ('bf16', torch.bfloat16, 4, False),
        ('fp32', torch.float32, 1, True))


def out_of_place_scan(u, delta, A, B, C, D):
    """The same scan, each round out of place under autograd."""
    gain = torch.exp(delta[..., None] * A)
    x = delta[..., None] * B[..., None, :] * u[..., None]
    length = u.shape[1]
    step = 1
    while step < length:
        x = torch.addcmul(x, gain, F.pad(x[:, :-step], (0, 0, 0, 0, step, 0)))
        if 2 * step < length:
            gain = gain * F.pad(gain[:, :-step], (0, 0, 0, 0, step, 0), value=1.)
        step *= 2
    y = torch.einsum('bln,bldn->bld', C, x)
    return y + u * D


DESIGNS = {'port': selective_scan_torch, 'out of place': out_of_place_scan}


def operands(batch, length, channels, dtype, grad):
    g = torch.Generator(device='cuda').manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device='cuda', generator=g)
    u = randn(batch, length, channels)
    delta = randn(batch, length, channels).abs() * 0.1 + 0.01
    A = -(randn(channels, N_STATE).abs() + 0.1)
    return [t.to(dtype).requires_grad_(grad) for t in (
        u, delta, A, randn(batch, length, N_STATE), randn(batch, length, N_STATE), randn(channels))]


def call(fn, args, grad):
    """The forward (and with ``grad`` the backward of its squares' sum); the
    output and the gradients."""
    with torch.set_grad_enabled(grad):
        y = fn(*args)
        if not grad:
            return y, []
        return y.detach(), torch.autograd.grad(y.square().sum(), args)


def median_ms(fn, args, grad, reps=5):
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        call(fn, args, grad)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[reps // 2]


def main():
    if not torch.cuda.is_available():
        print('torch_scan_ab: no CUDA device is available', file=sys.stderr)
        return 1
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for name, dtype, batch, grad in RUNS:
        what = 'forward and backward' if grad else 'forward'
        totals = dict.fromkeys(DESIGNS, 0.)
        for length, channels in STAGES:
            args = operands(batch, length, channels, dtype, grad)
            (y, gy), (z, gz) = (call(fn, args, grad) for fn in DESIGNS.values())
            same = torch.equal(y, z)
            grad_err = max((float((a - b).abs().max() / b.abs().max()) for a, b in zip(gy, gz)),
                           default=0.)
            del y, gy, z, gz
            ms = {k: [] for k in DESIGNS}
            for label in ('port', 'out of place', 'out of place', 'port'):
                ms[label].append(median_ms(DESIGNS[label], args, grad))
            peak = {}
            for label, fn in DESIGNS.items():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                call(fn, args, grad)
                peak[label] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            port, other = min(ms['port']), min(ms['out of place'])
            totals['port'] += port
            totals['out of place'] += other
            print(f'{name} batch {batch} {what}, L {length}, D {channels}, N {N_STATE}: port '
                  f'{port:.3f} ms ({peak["port"]:.2f} GiB above the inputs), out of place '
                  f'{other:.3f} ms ({peak["out of place"]:.2f} GiB), ratio {other / port:.3f}; '
                  f'forwards bit-equal {same}' +
                  (f', gradients within {grad_err:.2e} of their peak' if grad else ''), flush=True)
            if not same:
                print('torch_scan_ab: the two designs disagree', file=sys.stderr)
                return 1
            del args
            torch.cuda.empty_cache()
        print(f'{name} batch {batch} {what}, the four stages: port {totals["port"]:.3f} ms, out '
              f'of place {totals["out of place"]:.3f} ms, ratio '
              f'{totals["out of place"] / totals["port"]:.3f}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
