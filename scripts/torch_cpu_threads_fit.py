#!/usr/bin/env python3
"""Train ResNet-family CPNs on the CPU with several torch threads, one
subprocess per run, and report how each run ended.

``python3 scripts/torch_cpu_threads_fit.py [--threads 8] [--seeds 0 1 2]
[--steps 52] [--models CpnResNet18UNet CpnResNet18FPN]`` runs
``CPNTrainer.fit`` of each model (``base_channel`` 8, one input channel) on
8 toy images of 128^2 (``random_geometric_objects``) at batch 4, for
``--steps`` steps, with ``torch.set_num_threads(threads)``, each run in a
fresh Python process so that a heap corruption ("free(): invalid next size",
"double free or corruption") shows as a signal in the exit code instead of
killing the caller. One line per run: model, seed, exit code, seconds, the
last loss, and the tail of stderr when the run failed. Exits non-zero if any
run did.
"""
import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN = r'''
import sys
import numpy as np
import torch
torch.set_num_threads({threads})
torch.manual_seed({seed})
import celldetection_tpu_torch as ct
from celldetection_tpu_torch.data.toydata import random_geometric_objects
pairs = []
for i in range(8):
    image, labels = random_geometric_objects(128, 128, num=12, radius=(6, 16), seed={seed} * 100 + i)
    pairs.append((image[..., None], labels[..., 0]))
model = ct.models.get_cpn('{model}')(1, device='cpu', seed={seed},
                                     backbone_kwargs=dict(base_channel=8))
trainer = ct.CPNTrainer(model, optimizer={{'Adam': {{'lr': 1e-3}}}}, seed={seed},
                        log_fn=lambda *a, **k: None)
history = trainer.fit(pairs, epochs={epochs}, batch_size=4)
print('last loss', float(history[-1]['loss']) if history else float('nan'))
'''


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--threads', type=int, default=8)
    parser.add_argument('--seeds', type=int, nargs='+', default=[0, 1, 2])
    parser.add_argument('--steps', type=int, default=52)
    parser.add_argument('--models', nargs='+', default=['CpnResNet18UNet', 'CpnResNet18FPN'])
    args = parser.parse_args(argv)
    epochs = -(-args.steps // 2)       # 8 images at batch 4: two steps an epoch
    env = dict(os.environ, PYTHONPATH=HERE)
    failed = 0
    for model in args.models:
        for seed in args.seeds:
            code = RUN.format(threads=args.threads, seed=seed, model=model, epochs=epochs)
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, '-c', code], cwd=HERE, env=env,
                                  capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            last = [line for line in proc.stdout.splitlines() if line.startswith('last loss')]
            line = (f'{model} seed {seed}: exit {proc.returncode}, {seconds:.1f} s, '
                    f'{2 * epochs} steps at {args.threads} threads, '
                    f'{last[-1] if last else "no loss"}')
            if proc.returncode:
                failed += 1
                line += '\n  stderr: ' + ' | '.join(proc.stderr.strip().splitlines()[-5:])
            print(line, flush=True)
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main())
