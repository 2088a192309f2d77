"""Traffic kind ``tiles``: batches of 1024² tiles through ``CPN.forward_padded(..., nms=True)``.

A closed loop with one batch dispatched ahead, as the CLI's tile loop and
``bench.py`` run: the host dispatches batch i + 1 (input crop and cast on
the device, the forward, decode and NMS, the copies of boxes, scores and
valid flags to pinned host memory) before it waits for batch i's copies.
Each batch is a different crop of a seeded blob mosaic kept on the device;
the crop corners come from the seed. A tile is done when its boxes, scores
and valid flags are on the host; a batch's latency runs from the start of
its dispatch to that moment.

The mix sets ``batch``, ``tile``, ``precision``, ``pool_side`` (the mosaic
the crops come from), ``score_thresh``, ``warmup_batches``,
``check_batches`` (the sample the reference judges, drawn from the seed
over every batch of the window), ``trace_seconds`` and ``max_batches``
(crop corners drawn, used in turn).
"""
import time

import numpy as np
import torch

from .. import harness, judge, roofline, trace, traffic
from ..reference import cpn


class Tiles:
    def __init__(self, cell, seed: int, model=None):
        self.cell, self.mix, self.cfg = cell, cell.mix, cell.cfg
        self.dev = cell.device
        self.load(seed, model)

    def load(self, seed: int, model=None):
        """Weights, program, crop pool and crop corners of ``seed``."""
        mix, cell = self.mix, self.cell
        self.seed = seed
        self.weights = harness.cell_weights(cell, seed)
        if model is None:
            model = harness.build_program(cell, self.weights)
        else:
            model.load_state_dict(self.weights, strict=True)
        self.model = model
        side = mix['pool_side']
        self.pool = traffic.blob_mosaic(side, side, seed, self.dev, block=mix.get('block', 1024))
        self.offsets = traffic.crop_offsets(seed, mix['max_batches'], mix['batch'], side,
                                            mix['tile'])
        self.next = 0

    def inputs(self, i: int) -> torch.Tensor:
        t = self.mix['tile']
        corners = self.offsets[i % len(self.offsets)]
        return torch.stack([self.pool[y:y + t, x:x + t] for y, x in corners]).float() / 255.

    def dispatch(self, i: int) -> dict:
        t0 = time.perf_counter()
        with torch.profiler.record_function('h100_bench.dispatch'):
            out = self.model.forward_padded(self.inputs(i), score_thresh=self.mix['score_thresh'],
                                            nms=True)
            cuda = self.dev.type == 'cuda'
            host = {}
            for k in ('boxes', 'scores', 'valid'):
                host[k] = torch.empty(out[k].shape, dtype=out[k].dtype, pin_memory=cuda)
                host[k].copy_(out[k], non_blocking=cuda)
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record()
        return dict(i=i, t0=t0, out=out, host=host, event=event)

    def loop(self, seconds: float, keep=None):
        """Batches from ``self.next`` on until ``seconds`` have passed (the last
        one dispatched before then is waited for). ``keep(job)`` sees every
        finished batch. Returns ``(batches, first dispatch, last finish, latencies)``."""
        lat = []
        t_open = time.perf_counter()
        pending = self.dispatch(self.next)
        self.next += 1
        t_done = t_open
        while pending is not None:
            nxt = None
            if time.perf_counter() - t_open < seconds:
                nxt = self.dispatch(self.next)
                self.next += 1
            with torch.profiler.record_function('h100_bench.readback'):
                if pending['event'] is not None:
                    pending['event'].synchronize()
            t_done = time.perf_counter()
            lat.append(t_done - pending['t0'])
            if keep is not None:
                keep(pending)
            pending = nxt
        return len(lat), t_open, t_done, lat


def _reservoir(seed: int, size: int):
    """Uniform sample of ``size`` finished batches, drawn from the seed (reservoir sampling)."""
    rng = np.random.default_rng([int(seed), 11])
    kept, seen = [], [0]

    def keep(job):
        seen[0] += 1
        item = (job['i'], judge.kept_outputs(job['out']))
        if len(kept) < size:
            kept.append(item)
        else:
            j = int(rng.integers(0, seen[0]))
            if j < size:
                kept[j] = item
    return kept, keep


def reference_maps(st: Tiles, x: torch.Tensor) -> dict:
    """The reference's dense maps of a batch, image by image (float32, TF32 off)."""
    with cpn.exact_fp32(), torch.no_grad():
        parts = [cpn.dense_forward(st.cell.ref, st.weights, x[j:j + 1], st.cfg,
                                   cpn.Precision('fp32')) for j in range(x.shape[0])]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def judge_batches(st: Tiles, batches) -> dict:
    """The reference's judgement of ``(batch index, outputs)`` pairs: the
    largest gap and the sum of each count over them."""
    numbers = {}
    for i, prog in batches:
        ref = reference_maps(st, st.inputs(i))
        with cpn.exact_fp32():
            judge.merge(numbers, judge.judge_tiles(prog, ref, st.cfg, st.cfg['nms_thresh']))
    return numbers


def nms_timing(st: Tiles, prog: dict, calls: int = 200) -> dict:
    """The NMS of one sampled batch: the port's entry timed by CUDA events over
    ``calls`` calls, and the least time of the algorithm on those inputs, with
    the pair tests that the reference's keep mask needs."""
    from celldetection_tpu_torch.ops.boxes import nms_padded
    k = prog['fg_index'].shape[1]
    pre = torch.arange(k, device=st.dev)[None] < prog['fg_count'].clamp(max=k)[:, None]
    boxes, scores, thresh = prog['boxes'], prog['scores'], st.cfg['nms_thresh']
    for _ in range(3):
        nms_padded(boxes, scores, pre, thresh)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(calls):
        nms_padded(boxes, scores, pre, thresh)
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b) / calls
    keep = torch.stack([cpn.greedy_nms(boxes[i], scores[i], pre[i], thresh)
                        for i in range(boxes.shape[0])])
    sb, sv, order = roofline.sorted_inputs(boxes, scores, pre)
    bound, what, tests = roofline.nms_bound(sb, sv, torch.gather(keep, 1, order), thresh)
    return dict(device_ms=ms, bound_ms=bound, bound_by=what, pair_tests=tests)


def run(cell, args, t_start: float) -> dict:
    mix = cell.mix
    st = Tiles(cell, args.seed)
    with torch.no_grad():
        st.loop(0.)                                   # the first batch builds and warms
        for _ in range(mix['warmup_batches'] - 1):
            st.loop(0.)
        harness.reset_peak(st.dev)
        samples, keep = _reservoir(args.seed, mix['check_batches'])
        setup_s = time.perf_counter() - t_start
        batches, t_open, t_close, lat = st.loop(args.seconds, keep)
        peak = harness.peak_bytes(st.dev)
        window = t_close - t_open
        tiles = batches * mix['batch']
        data = dict(kind='tiles', tiles_per_s=tiles / window, precision=mix['precision'],
                    peak_bytes=peak, batch=mix['batch'])
        if args.trace:
            data['trace'] = trace.record(lambda: st.loop(mix['trace_seconds']))
            data['nms'] = nms_timing(st, samples[0][1])
            data['flops_per_tile'] = cell_flops(cell)
        st.model = None
        if st.dev.type == 'cuda':
            torch.cuda.empty_cache()
        numbers = judge_batches(st, samples)
    e2e = dict(tiles_per_s=tiles / window, tile_ms_p95=float(np.percentile(lat, 95)) * 1e3,
               setup_s=setup_s)
    return dict(e2e=e2e, attempted=tiles, failed=0, numbers=numbers, data=data, peak=peak,
                info=dict(batches=batches, window_s=window, p50_ms=float(np.median(lat)) * 1e3))


def cell_flops(cell) -> float:
    """FLOPs of one tile's forward through the configuration (see :mod:`..flops`)."""
    from ..flops import forward_flops
    t = cell.mix['tile']
    return forward_flops(cell.ref, cell.cfg, 1, t, t)[0]
