#!/usr/bin/env python3
"""The ConvNeXt-Large CPN's benchmark cell on one CUDA card: its random weights, its times by span,
and what the check that decides ``correct`` sees of the ConvNeXt block.

On ``cnxl_tiles_bf16_b4`` (``h100_bench/``: CpnConvNeXtLargeUNet at its published widths, 1024^2
tiles, bf16 batch 4) with the cell's own weights of one seed, it prints:

* for the configuration's layer scale (γ ~ U(0.05, 0.15)), the default draw (0.1 N(0, 1)) and the
  published initial 1e-6: each block's added output over its input's norm, and the share of a
  tile's score probabilities in (0.01, 0.99) (where random weights saturate the sigmoid, the
  check compares little);
* the CUDA-event ms a forward of each span (``convnext.stage`` by stage, ``cpn.core``,
  ``cpn.head_conv`` by output channels, ...), over three forwards, the ``host_syncs`` that each
  of those forwards counts on its ``cpn.forward`` span, and the peak memory;
* the judge's numbers on three batches: sound; with every block's γ x1.03, x1.1 and x1.3; with
  the tanh GELU in place of the exact one; with the encoder's LayerNorm epsilon 1e-5 in place of
  1e-6; and with every block cut to its residual (no MLP). Each is the program changed for the
  probe alone and restored after it.

Run from the repository root on a machine with a card:
``python3 scripts/torch_convnext_cell_probe.py [--seed N] [--out probe.json]``.
"""
import argparse
import json
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch import nn  # noqa: E402

from celldetection_tpu_torch.models import convnext  # noqa: E402
from celldetection_tpu_torch.util import spans  # noqa: E402
from h100_bench import harness, judge, weights as weights_lib  # noqa: E402
from h100_bench.drivers import tiles  # noqa: E402

CELL = 'cnxl_tiles_bf16_b4'
BATCHES = 3


def blocks(model):
    return [m for m in model.modules() if isinstance(m, convnext.CNBlock)]


def weight_stats(st) -> dict:
    """Each block's added output over its input's norm, and the score probabilities."""
    added, hooks = [], []
    for m in blocks(st.model):
        hooks.append(m.register_forward_hook(
            lambda mod, inp, res: added.append(float((res - inp[0]).float().norm()
                                                     / inp[0].float().norm()))))
    try:
        with torch.no_grad():
            res = st.model.forward_padded(st.inputs(0), score_thresh=0., nms=True)
    finally:
        for h in hooks:
            h.remove()
    p = torch.sigmoid(res['dense_scores'].float())
    return dict(block_over_input=dict(min=min(added), max=max(added),
                                      mean=sum(added) / len(added), each=added),
                mid_share=float(((p > .01) & (p < .99)).float().mean()),
                p_min=float(p.min()), p_max=float(p.max()))


def span_ms(st, forwards: int = 3):
    """CUDA-event ms a forward of every span, over ``forwards`` forwards after two warm ones,
    and each forward's ``host_syncs``."""
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
        name = r['name']
        if name == 'convnext.stage':
            name += str(r['counts']['stage'])
        elif name == 'cpn.head_conv':
            name += f".{r['counts']['cout']}"
        out[name] = out.get(name, 0.) + r['stream_ms'] / forwards
    return out, [r['counts'].get('host_syncs') for r in recs if r['name'] == 'cpn.forward']


def judged(st, refs) -> dict:
    numbers = {}
    with torch.no_grad():
        for i in range(BATCHES):
            prog = judge.kept_outputs(st.model.forward_padded(st.inputs(i), score_thresh=0.,
                                                              nms=True))
            judge.merge(numbers, judge.judge_tiles(prog, refs[i], st.cfg, st.cfg['nms_thresh']))
    return numbers


class _Functional(types.SimpleNamespace):
    """``torch.nn.functional`` with one function replaced."""

    def __getattr__(self, name):
        return getattr(F, name)


def probes(st, refs) -> dict:
    out = {}
    scales = [m.layer_scale for m in blocks(st.model)]
    saved = [s.detach().clone() for s in scales]
    for k in (1.03, 1.1, 1.3):
        with torch.no_grad():
            for s, v in zip(scales, saved):
                s.copy_(v * k)
        out[f'gamma_x{k}'] = judged(st, refs)
        print(f'gamma_x{k}', json.dumps(out[f'gamma_x{k}']), flush=True)
    with torch.no_grad():
        for s, v in zip(scales, saved):
            s.copy_(v)
    convnext.F = _Functional(gelu=lambda x: F.gelu(x, approximate='tanh'))
    try:
        out['gelu_tanh'] = judged(st, refs)
    finally:
        convnext.F = F
    print('gelu_tanh', json.dumps(out['gelu_tanh']), flush=True)
    norms = [m for m in st.model.core.backbone.body.modules() if isinstance(m, nn.LayerNorm)]
    for m in norms:
        m.eps = 1e-5
    try:
        out['ln_eps_1e-5'] = judged(st, refs)
    finally:
        for m in norms:
            m.eps = 1e-6
    print('ln_eps_1e-5', json.dumps(out['ln_eps_1e-5']), flush=True)
    forward = convnext.CNBlock.forward
    convnext.CNBlock.forward = lambda self, x: x
    try:
        out['blocks_cut'] = judged(st, refs)
    finally:
        convnext.CNBlock.forward = forward
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--seed', type=int, default=2 ** 31 + 22222)
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA card')
    cell = harness.load_cell(CELL)
    out = dict(card=torch.cuda.get_device_name(0), seed=args.seed, limits=cell.limits)
    t0 = time.perf_counter()
    st = tiles.Tiles(cell, args.seed)
    out['setup_s'] = time.perf_counter() - t0
    out['gamma_u0.05_0.15'] = weight_stats(st)
    out['span_ms'], out['host_syncs'] = span_ms(st)
    out['peak_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30
    print('spans', json.dumps(out['span_ms']), 'host_syncs', out['host_syncs'], flush=True)
    refs = [tiles.reference_maps(st, st.inputs(i)) for i in range(BATCHES)]
    out['sound'] = judged(st, refs)
    print('sound', json.dumps(out['sound']), flush=True)
    out.update(probes(st, refs))
    shapes = cell.ref.shapes(cell.cfg)
    default = weights_lib.make_weights(shapes, args.seed, st.dev, cell.cfg['weight_factors'])
    st.model.load_state_dict(default, strict=True)
    out['gamma_default_0.1N'] = weight_stats(st)
    with torch.no_grad():
        for m in blocks(st.model):
            m.layer_scale.fill_(1e-6)
    out['gamma_published_1e-6'] = weight_stats(st)
    for key in ('gamma_default_0.1N', 'gamma_published_1e-6'):
        out[key]['block_over_input'].pop('each')
    if args.out:
        with open(args.out, 'w') as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps(out))


if __name__ == '__main__':
    main()
