#!/usr/bin/env python3
"""What the port's span recorder costs when it records: one benchmark run with it on throughout.

    python3 scripts/torch_spans_cost.py --spans on -- \
        --workload u22_tiles_fp32_b1 --seed 7 --seconds 40

Runs ``h100_bench/run.py`` in this process with the arguments after ``--``.
With ``--spans on`` it first calls ``celldetection_tpu_torch.util.spans.enable()``,
so every span of the measured window records (a ``record_function``, a CUDA
event pair and a record each), where the benchmark's own ``--trace 0`` runs
record none; ``--spans off`` runs it as the benchmark does. The last line is
``run.py``'s result line. Compare the end-to-end metrics of runs on and off
taken in turns within one chip call.
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    argv = sys.argv[1:]
    cut = argv.index('--') if '--' in argv else len(argv)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--spans', choices=('on', 'off'), required=True)
    args = p.parse_args(argv[:cut])
    from h100_bench import run
    if args.spans == 'on':
        from celldetection_tpu_torch.util import spans
        spans.enable()
    return run.main(argv[cut + 1:])


if __name__ == '__main__':
    sys.exit(main())
