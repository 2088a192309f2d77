#!/usr/bin/env python3
"""How sound the bf16 hold of ``chip_smoke.py`` phase 19c is, on one CUDA card.

Phase 19c holds CpnResNet50UNet with a ``MambaLayer`` after every encoder
stage (full width) in bf16 at batch 4 against the same model in fp32 on four
toy images of 512^2, after 12 fp32 training steps on toy images, under the
gates of ``chip_smoke.py: bf16_hold``. This script runs that hold

1. over four training seeds and two sets of toy images (the sound runs;
   set 0 and training seed 0 are phase 19c's own), and the first of them a
   second time, to show whether training on the card repeats;
2. on three controls that must fail, on the first sound run's weights:
   the bf16 run with its scan dropped (``y = D u``), and with every
   parameter of the bf16 model scaled by ``1 + e n`` (``n`` standard normal,
   ``e`` 1% and 3%);
3. with the scan alone in fp32 inside the bf16 model, on toy images and on
   uniform noise (where the bf16 run's counts part from fp32's): whether the
   scan's bf16 arithmetic is what parts them.

Each run prints its readings and PASS or FAIL; the last lines count them.
Run from the repository root on a machine with a card:
``python3 scripts/torch_mamba_bf16_hold.py``.
"""
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from celldetection_tpu_torch.models import mamba  # noqa: E402

TRAIN_SEEDS, IMAGE_SETS = (0, 1, 2, 3), (0, 1)
PLAIN_SCAN = mamba.selective_scan


def build(**kw):
    return cs.models.CpnResNet50UNet(in_channels=3, backbone_kwargs={
        'secondary_block': cs.models.MambaLayer}, max_detections=2048, samples=32, **kw)


def toy_inputs(image_set):
    """Phase 19c's four toy images of 512^2 for set 0, the next seeds for others."""
    toy = np.stack([cs.random_geometric_objects(512, 512, num=40, radius=(6, 14),
                                                seed=100 + 4 * image_set + i)[0]
                    for i in range(4)])
    return torch.from_numpy(np.repeat(toy[..., None], 3, -1).astype(np.float32)).cuda()


def bf16_scan(variant):
    """``selective_scan`` with its bf16 calls replaced: 'dropped' gives ``D u``,
    'fp32' computes the scan in float32 and casts the result back."""
    def scan(u, delta, A, B, C, D):
        if u.dtype != torch.bfloat16:
            return PLAIN_SCAN(u, delta, A, B, C, D)
        if variant == 'dropped':
            return u * D
        return PLAIN_SCAN(*(t.float() for t in (u, delta, A, B, C, D))).to(u.dtype)
    return scan


def run(label, m32, sd, x, thresh, scan=None, noise=0.):
    m16 = build(compute_dtype=torch.bfloat16)
    m16.load_state_dict(sd, strict=True)
    if noise:
        g = torch.Generator(device='cuda').manual_seed(cs.SEED)
        with torch.no_grad():
            for p in m16.parameters():
                p.mul_(1 + noise * torch.randn(p.shape, generator=g, device=p.device))
    mamba.selective_scan = scan or PLAIN_SCAN
    try:
        t0 = time.perf_counter()
        fails, line = cs.bf16_hold(m32, m16, x, thresh)
    finally:
        mamba.selective_scan = PLAIN_SCAN
    verdict = 'FAIL' if fails else 'PASS'
    print(f'  {label}: {verdict} ({time.perf_counter() - t0:.1f} s) {line}', flush=True)
    return not fails, line


def main():
    if not torch.cuda.is_available():
        print('torch_mamba_bf16_hold: no CUDA device is available', file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card, flush=True)
    print(f'gates: counts within 8% (at least 2), matched >= 0.92 at IoU 0.8, contours < 0.5 px, '
          f'logits |diff| / std p99 <= {cs.BF16_LOGIT_P99}', flush=True)
    t_start = time.perf_counter()
    sd0 = cs.random_weights(build(), tame=True)
    sound, first = [], None
    print('== sound runs', flush=True)
    for train_seed in TRAIN_SEEDS:
        for image_set in IMAGE_SETS:
            x = toy_inputs(image_set)
            m32, sd, thresh = cs.trained_like(build, sd0, x, train_seed)
            ok, line = run(f'training seed {train_seed}, image set {image_set}', m32, sd, x,
                           thresh)
            sound.append(ok)
            if first is None:
                first = (m32, sd, x, thresh, line)
            torch.cuda.empty_cache()
    x = toy_inputs(0)
    m32, sd, thresh = cs.trained_like(build, sd0, x, 0)
    _, line = run('training seed 0, image set 0, again', m32, sd, x, thresh)
    repeats = line == first[4]
    m32, sd, x, thresh, _ = first
    print('== controls (must fail)', flush=True)
    controls = [run('scan dropped in bf16', m32, sd, x, thresh, scan=bf16_scan('dropped'))[0]]
    for e in (0.01, 0.03):
        controls.append(run(f'bf16 parameters scaled by 1 + {e} n', m32, sd, x, thresh,
                            noise=e)[0])
    print('== the scan alone in fp32 inside the bf16 model', flush=True)
    run('toy image set 0, fp32 scan', m32, sd, x, thresh, scan=bf16_scan('fp32'))
    noise = torch.from_numpy(np.random.RandomState(cs.SEED).rand(4, 512, 512, 3)
                             .astype(np.float32)).cuda()
    m32, sd, thresh = cs.trained_like(build, sd0, noise, 0)
    run('uniform noise, bf16 scan', m32, sd, noise, thresh)
    run('uniform noise, fp32 scan', m32, sd, noise, thresh, scan=bf16_scan('fp32'))
    print(f'sound runs passed: {sum(sound)} of {len(sound)}; the repeated run '
          f'{"repeats" if repeats else "differs"}; controls failed: '
          f'{sum(not c for c in controls)} of {len(controls)}; '
          f'{time.perf_counter() - t_start:.1f} s', flush=True)
    print(card, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
