"""Benchmark of celldetection_tpu_torch on an NVIDIA H100: one cell of ``BENCHMARK.json`` per run.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for. The last line of standard output is one JSON object: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics (read from a profiled stretch of the same loop after the
measured window), and in both the numbers that decide ``correct``, each
beside its limit (also the last lines of standard error). The program's
build and kernel caches live inside the checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, '.h100_bench_cache')


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    os.environ['TRITON_CACHE_DIR'] = os.path.join(CACHE, 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(CACHE, 'torch_extensions')
    os.environ['CUDA_CACHE_PATH'] = os.path.join(CACHE, 'cuda')
    os.environ.setdefault('USE_FLAX', '0')
    sys.path.insert(0, ROOT)
    import torch
    from h100_bench import harness

    cell = harness.load_cell(args.workload)
    chips = cell.entry['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'h100_bench: the cell needs {chips} CUDA card(s); '
              f'cuda available: {torch.cuda.is_available()}, '
              f'cards: {torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    res = harness.driver(cell).run(cell, args, T_START)

    bad = harness.forbidden_modules()
    if bad:
        print(f'h100_bench: modules of JAX or of the JAX package were loaded: {bad}',
              file=sys.stderr)
        return 4
    correct, checks = harness.compare(res['numbers'], cell.limits)
    if args.trace:
        metrics = harness.read_layer_metrics(cell, res['data'])
    else:
        names = [m['name'] for m in cell.end_to_end]
        units = {m['name']: m['unit'] for m in cell.end_to_end}
        metrics = {n: {'value': res['e2e'][n], 'unit': units[n]} for n in names}
    device = dict(platform='gpu', kind=torch.cuda.get_device_name(0), count=chips,
                  memory_peak_bytes=int(res['peak']))
    line = dict(correct=correct, attempted=res['attempted'], failed=res['failed'],
                metrics=metrics, device=device)
    tr = res['data'].get('trace')
    if args.trace and tr:
        device.update(busy_s=tr.get('busy_s', 0.), window_s=tr['window_s'])
        line['breakdown'] = dict(device_ops=tr.get('device_ops', []),
                                 idle_gaps=tr.get('idle_gaps', []))
    line['checks'] = checks
    info = dict(res.get('info', {}))
    if 'nms' in res['data']:
        info['nms'] = res['data']['nms']
    if tr:
        info['trace'] = {k: v for k, v in tr.items() if k not in ('device_ops', 'idle_gaps')}
    print('h100_bench: ' + json.dumps(info), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == '__main__':
    sys.exit(main())
