"""Readings from which a cell's limits are set: sound runs of the program and the control.

    python3 h100_bench/calibrate.py --workload <cell> --seeds 1,2,... --controls 7,8,9 [--seconds 2]

In one process, for each seed of ``--seeds``: the cell's set-up, a short
window of its timed path, and the check of ``correct``; for each seed of
``--controls``: the control, the reference in the next lower precision
(bf16 for an fp32 cell, fp8 for a bf16 one) put in the program's place on
the same inputs, judged by the same comparison. Each reading is a JSON
line on standard output; the last line gives, for each number, the largest
sound reading and the smallest control reading. The benchmark's own runs
never run the control.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

CONTROL = {'fp32': 'bf16', 'bf16': 'fp8'}


def sound(cell, drv, seed, seconds, state):
    import torch
    if state.get('st') is None:
        state['st'] = (drv.Tiles if cell.mix['kind'] == 'tiles' else drv.Mosaic)(cell, seed)
    else:
        state['st'].load(seed, state['st'].model)
    st = state['st']
    with torch.no_grad():
        if cell.mix['kind'] == 'tiles':
            st.loop(0.)
            samples, keep = drv._reservoir(seed, cell.mix['check_batches'])
            st.loop(seconds, keep)
            return drv.judge_batches(st, samples)
        st.call()
        return drv.check(st, st.loop(seconds, 0)[3])[0]


def control(cell, drv, seed, state):
    """The control's numbers: the reference at the lower precision in the program's place."""
    import torch
    from h100_bench.reference import cpn, stitch
    st = state['st']
    st.load(seed, st.model)
    prec = cpn.Precision(CONTROL[cell.mix['precision']])
    with torch.no_grad():
        if cell.mix['kind'] == 'tiles':
            return drv.judge_batches(st, [
                (i, cpn.infer_padded(cell.ref, st.weights, st.inputs(i), cell.cfg, prec,
                                     cell.mix['score_thresh'], cell.cfg['nms_thresh']))
                for i in range(cell.mix['check_batches'])])
        img = torch.from_numpy(st.image).to(st.dev)
        calls = stitch.window_calls(cell.ref, st.weights, img, cell.cfg, prec, st.thresh,
                                    cell.mix, st.geom['factor'])
        per, order = stitch.windows_of_calls(calls, len(st.geom['offsets']), 1,
                                             cell.cfg['max_detections'], st.geom['factor'])
        final = stitch.stitch(per, order, st.geom['offsets'], st.geom['borders'], cell.cfg,
                              cell.mix)[2]
        mix = st.mix
        st.mix = dict(mix, batch=1)
        try:
            return drv.check(st, dict(calls=calls, final=final))[0]
        finally:
            st.mix = mix


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--controls', default='')
    p.add_argument('--seconds', type=float, default=2.)
    args = p.parse_args(argv)
    from h100_bench import harness
    cell = harness.load_cell(args.workload)
    drv = harness.driver(cell)
    state, lows, highs = {}, {}, {}
    for kind, seeds in (('sound', args.seeds), ('control', args.controls)):
        for seed in [int(s) for s in seeds.split(',') if s]:
            t0 = time.perf_counter()
            numbers = (sound(cell, drv, seed, args.seconds, state) if kind == 'sound'
                       else control(cell, drv, seed, state))
            ok, _ = harness.compare(numbers, cell.limits)
            seconds = time.perf_counter() - t0
            print(json.dumps(dict(kind=kind, seed=seed, correct=ok, seconds=seconds,
                                  numbers=numbers)), flush=True)
            for k, v in numbers.items():
                if kind == 'sound':
                    lows[k] = max(lows.get(k, v), v)
                else:
                    highs[k] = min(highs.get(k, v), v)
    print(json.dumps(dict(kind='summary', workload=args.workload, sound_max=lows,
                          control_min=highs)))


if __name__ == '__main__':
    main()
