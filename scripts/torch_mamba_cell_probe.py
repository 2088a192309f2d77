#!/usr/bin/env python3
"""The Mamba CPN's benchmark cell on one CUDA card: its random weights, its times by span, and
whether the check that decides ``correct`` sees the scan.

On ``rn50mamba_tiles_fp32_b1`` (``h100_bench/``: CpnResNet50UNet with a ``MambaLayer`` after each
encoder stage, published widths, 1024^2 tiles, fp32 batch 1) with the cell's own weights of one
seed, it prints:

* for the ``out_proj`` factor of the configuration and for x0.1 and x1: each Mamba layer's
  added output over its input's norm, and the share of a tile's score probabilities in
  (0.01, 0.99) (where random weights saturate the sigmoid, the check compares little);
* the CUDA-event ms a forward of each span (``mamba.layer``, ``mamba.scan``, ``cpn.core``, ...),
  over three forwards, and the peak memory;
* the judge's numbers on four batches: sound; with the program's scan cut to its skip term
  ``D u``; with the scan's output x1.01, x0.99, x1.03 and x1.1 (how large a scan error the
  limits see); and with the scan's operands and state in bf16, the rest in fp32.

Run from the repository root on a machine with a card:
``python3 scripts/torch_mamba_cell_probe.py [--seed N] [--out probe.json]``.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch  # noqa: E402

from celldetection_tpu_torch.models import mamba  # noqa: E402
from celldetection_tpu_torch.util import spans  # noqa: E402
from h100_bench import harness, judge  # noqa: E402
from h100_bench.drivers import tiles  # noqa: E402

CELL = 'rn50mamba_tiles_fp32_b1'
OUT_PROJ = '^core\\.backbone\\.body\\.secondary\\d\\.mamba\\.out_proj\\.weight$'


def weight_stats(st) -> dict:
    """Each Mamba layer's added output over its input's norm, and the score probabilities."""
    added, hooks = {}, []
    body = st.model.core.backbone.body
    for i in range(1, 5):
        def hook(mod, inp, res, i=i):
            added[i] = float((res - inp[0]).norm() / inp[0].norm())
        hooks.append(getattr(body, f'secondary{i}').register_forward_hook(hook))
    try:
        with torch.no_grad():
            res = st.model.forward_padded(st.inputs(0), score_thresh=0., nms=True)
    finally:
        for h in hooks:
            h.remove()
    p = torch.sigmoid(res['dense_scores'].float())
    return dict(mamba_over_input=added, mid_share=float(((p > .01) & (p < .99)).float().mean()),
                p_min=float(p.min()), p_max=float(p.max()))


def span_ms(st, forwards: int = 3) -> dict:
    """CUDA-event ms a forward of every span, over ``forwards`` forwards after two warm ones."""
    with torch.no_grad():
        for i in range(2):
            st.model.forward_padded(st.inputs(i), score_thresh=0., nms=True)
        torch.cuda.synchronize()
        spans.reset()
        spans.enable()
        try:
            for i in range(forwards):
                st.model.forward_padded(st.inputs(2 + i), score_thresh=0., nms=True)
            recs = spans.collect()
        finally:
            spans.disable()
            spans.reset()
    out = {}
    for r in recs:
        out[r['name']] = out.get(r['name'], 0.) + r['stream_ms'] / forwards
    return out


def judged(st, batches: int = 4) -> dict:
    numbers = {}
    with torch.no_grad():
        for i in range(batches):
            prog = judge.kept_outputs(st.model.forward_padded(st.inputs(i), score_thresh=0.,
                                                              nms=True))
            judge.merge(numbers, judge.judge_tiles(prog, tiles.reference_maps(st, st.inputs(i)),
                                                   st.cfg, st.cfg['nms_thresh']))
    return numbers


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--seed', type=int, default=2 ** 31 + 12345)
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA card')
    cell = harness.load_cell(CELL)
    out = dict(card=torch.cuda.get_device_name(0), seed=args.seed)
    t0 = time.perf_counter()
    st = tiles.Tiles(cell, args.seed)
    out['setup_s'] = time.perf_counter() - t0
    factors = [f for f in cell.cfg['weight_factors'] if f[0] != OUT_PROJ]
    own = next(f[1] for f in cell.cfg['weight_factors'] if f[0] == OUT_PROJ)
    out[f'factor_{own}'] = weight_stats(st)
    out['span_ms'] = span_ms(st)
    out['peak_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30
    out['sound'] = judged(st)
    scan = mamba.selective_scan
    try:
        mamba.selective_scan = lambda u, delta, A, B, C, D: u * D
        out['scan_cut_to_skip'] = judged(st)
        for k in (1.01, 0.99, 1.03, 1.1):
            mamba.selective_scan = lambda *a, k=k: scan(*a) * k
            out[f'scan_x{k}'] = judged(st)
        mamba.selective_scan = lambda *a: scan(*(t.bfloat16() for t in a)).float()
        out['scan_bf16'] = judged(st)
    finally:
        mamba.selective_scan = scan
    out['limits'] = cell.limits
    for f in (0.1, 1.0):
        cell.cfg = dict(cell.cfg, weight_factors=factors + [[OUT_PROJ, f]])
        st.load(args.seed, st.model)
        out[f'factor_{f}'] = weight_stats(st)
    if args.out:
        with open(args.out, 'w') as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps(out))


if __name__ == '__main__':
    main()
