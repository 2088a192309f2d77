"""Device trace of a short window: ``torch.profiler`` (CUPTI) over the same
loop the measured window runs, reduced to busy time, idle gaps by what the
host was doing, the device operations that took most time, and the share of
busy time spent in convolutions.

The chrome trace that the profiler exports is read back (its format is the
most stable across PyTorch versions): device intervals are its ``kernel``,
``gpu_memcpy`` and ``gpu_memset`` events; host ops its ``cpu_op`` and
``user_annotation`` events, on the same clock. A kernel belongs to a
convolution when the op that launched it (found through the launch's
``correlation`` id) or one of that op's parents is a convolution op of
``kernel_classes.json``, or when its own name matches one of the names there.
"""
import json
import os
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
WINDOW = 'h100_bench.traced_window'
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def classes() -> dict:
    with open(os.path.join(HERE, 'kernel_classes.json')) as f:
        return json.load(f)


def record(fn):
    """Run ``fn()`` under the profiler; returns the reduced trace (see :func:`reduce`)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'trace.json')
        t0 = time.perf_counter()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    out = reduce(events)
    out['export_s'] = time.perf_counter() - t0
    return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _chains(host, queries):
    """For each query ``(ts, tid)``, the names of the host ops of thread
    ``tid`` open at ``ts``, outermost first (one sweep per thread)."""
    by_tid = {}
    for e in host:
        by_tid.setdefault(e.get('tid'), []).append(e)
    out = [()] * len(queries)
    for tid, ops in by_tid.items():
        ops.sort(key=lambda e: (e['ts'], -e['dur']))
        qs = sorted((q[0], i) for i, q in enumerate(queries) if q[1] == tid)
        stack, j = [], 0
        for ts, i in qs:
            while j < len(ops) and ops[j]['ts'] <= ts:
                while stack and stack[-1]['ts'] + stack[-1]['dur'] < ops[j]['ts']:
                    stack.pop()
                stack.append(ops[j])
                j += 1
            while stack and stack[-1]['ts'] + stack[-1]['dur'] < ts:
                stack.pop()
            out[i] = tuple((e['name'], e.get('cat')) for e in stack)
    return out


def reduce(events) -> dict:
    """Busy and window seconds, idle gaps by host label, top device ops, conv share."""
    cls = classes()
    window = [e for e in events if e.get('name') == WINDOW and e.get('ph') == 'X']
    if not window:
        return {}
    w0, w1 = window[0]['ts'], window[0]['ts'] + window[0]['dur']
    dev = [e for e in events if e.get('ph') == 'X' and e.get('cat') in DEVICE_CATS
           and e['ts'] + e['dur'] >= w0 and e['ts'] <= w1]
    if not dev:
        return dict(window_s=(w1 - w0) * 1e-6)
    merged = _union((max(e['ts'], w0), min(e['ts'] + e['dur'], w1)) for e in dev)
    busy = sum(e - s for s, e in merged)
    host = [e for e in events if e.get('ph') == 'X' and e.get('name') != WINDOW
            and e.get('cat') in ('cpu_op', 'user_annotation')]
    launches = {e['args'].get('correlation'): e for e in events
                if e.get('cat') == 'cuda_runtime' and 'args' in e}
    conv_ops, conv_names = set(cls['conv_ops']), [n.lower() for n in cls['conv_kernel_names']]
    kernels = [e for e in dev if e.get('cat') == 'kernel']
    launch_of = [launches.get(e.get('args', {}).get('correlation')) for e in kernels]
    chains = _chains(host, [(la['ts'], la.get('tid')) if la else (-1, None) for la in launch_of])
    by_name, conv = {}, 0.
    for e in dev:
        by_name[e['name']] = by_name.get(e['name'], 0.) + e['dur']
    for e, chain in zip(kernels, chains):
        if any(n in e['name'].lower() for n in conv_names) or \
                any(name in conv_ops for name, _ in chain):
            conv += e['dur']
    edges = [w0] + [x for s, e in merged for x in (s, e)] + [w1]
    gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    idle = {}
    for (s, e), chain in zip(gaps, _chains(host, [(s, window[0].get('tid')) for s, _ in gaps])):
        notes = [n for n, cat in chain if cat == 'user_annotation']
        inner = chain[-1][0] if chain else 'no host op'
        label = ' > '.join(notes[-1:] + [inner]) if notes and notes[-1] != inner else inner
        idle[label] = idle.get(label, 0.) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy * 1e-6, window_s=(w1 - w0) * 1e-6, conv_s=conv * 1e-6,
                device_ops=[[n, d * 1e-6] for n, d in top],
                idle_gaps=[[n, d * 1e-6]
                           for n, d in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
                kernels=sum(1 for e in dev if e.get('cat') == 'kernel'))
