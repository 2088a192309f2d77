"""Traffic kind ``mosaic``: one seeded 8-bit RGB blob mosaic, again and again,
through ``TiledInference.__call__`` on one card.

The mosaic is a numpy array on the host, as the CLI hands an image read from
disk; each call tiles it on the host, runs the tile forwards, filters and
stitches the candidates with one exact NMS, and reads back the kept
detections. The window closes at the first mosaic finished after
``--seconds``, so that no mosaic is cut.

The score threshold is the highest that leaves at most ``fg_max`` pixels
above it in every window of the mosaic, found at set-up from the program's
dense scores of every window: no window overflows its capacity, and the
stitch sweeps every window's rows. The reference checks the candidates that
pass it against its own scores (``fg_drop_gap``, ``score_gap``).

The mix sets ``side``, ``tile``, ``stride``, ``batch``, ``precision``,
``max_outputs``, ``fg_max``, ``border`` and ``min_box`` (the program's
defaults, which the reference copies), ``check_index`` (the mosaics of the
window from which the checked one is drawn). The traced stretch is one mosaic.
"""
import time

import numpy as np
import torch

from .. import harness, judge, roofline, trace, traffic
from ..reference import cpn, stitch

STATS = ('forward_ms', 'retry_ms', 'stitch_ms', 'readback_ms', 'total_ms')


class Mosaic:
    def __init__(self, cell, seed: int, model=None):
        self.cell, self.mix, self.cfg = cell, cell.mix, cell.cfg
        self.dev = cell.device
        self.load(seed, model)

    def load(self, seed: int, model=None):
        from celldetection_tpu_torch.parallel.tiles import TiledInference
        mix, cell = self.mix, self.cell
        self.seed = seed
        self.weights = harness.cell_weights(cell, seed)
        if model is None:
            model = harness.build_program(cell, self.weights)
        else:
            model.load_state_dict(self.weights, strict=True)
        self.model = model
        side = mix['side']
        self.image = traffic.blob_mosaic(side, side, seed, self.dev,
                                          block=mix.get('block', 1024)).cpu().numpy()
        offs, borders = stitch.tiling(side, side, mix['tile'], mix['stride'])
        self.geom = dict(offsets=offs, borders=borders, factor=8)
        self.thresh = self.threshold()
        self.tiled = TiledInference(model, tile_size=mix['tile'], stride=mix['stride'],
                                    batch_size=mix['batch'], max_outputs=mix['max_outputs'],
                                    border_removal=mix['border'])
        self.geom['factor'] = self.tiled.max_capacity_factor
        # the checked mosaic keeps what each of its window forwards returned
        self.capture = None
        model.__dict__.pop('forward_padded', None)
        forward = model.forward_padded

        def forward_padded(*a, **kw):
            out = forward(*a, **kw)
            if self.capture is not None:
                self.capture['calls'].append(judge.kept_outputs(out))
            return out
        model.forward_padded = forward_padded

    def windows(self, img, ts) -> torch.Tensor:
        """Windows ``ts`` of the mosaic ``img`` (on the device) as NHWC floats in [0, 1]."""
        t = self.mix['tile']
        return torch.stack([img[y:y + t, x:x + t] for x, y in self.geom['offsets'][ts].astype(int)]
                           ).float() / 255.

    def threshold(self) -> float:
        """The highest score threshold with at most ``fg_max`` pixels above it in every window."""
        mix, n = self.mix, len(self.geom['offsets'])
        img = torch.from_numpy(self.image).to(self.dev)
        cut = -1.
        for s in range(0, n, mix['batch']):
            x = self.windows(img, np.arange(s, min(s + mix['batch'], n)))
            out = self.model.forward_padded(x, nms=False)
            p = torch.sigmoid(out['dense_scores'][..., 0].float()).reshape(x.shape[0], -1)
            cut = max(cut, float(torch.topk(p, mix['fg_max'] + 1, 1).values[:, -1].max()))
        return cut

    def call(self, capture: bool = False):
        self.capture = {'calls': []} if capture else None
        with torch.profiler.record_function('h100_bench.mosaic'):
            res = self.tiled(self.image, score_thresh=self.thresh)
        if capture:
            self.capture['final'] = res
        stats = {k: self.tiled.stats[k] for k in STATS}
        stats['retried_tiles'] = self.tiled.stats['retried_tiles']
        stats['nms_ms'] = sum(p['ms'] for p in self.tiled.stats['nms'])
        return stats

    def loop(self, seconds: float, capture_index: int = -1):
        t_open = time.perf_counter()
        stats, caught = [], None
        while True:
            stats.append(self.call(capture=len(stats) == capture_index))
            if len(stats) - 1 == capture_index:
                caught, self.capture = self.capture, None
            if time.perf_counter() - t_open >= seconds:
                return stats, t_open, time.perf_counter(), caught


def check(st: Mosaic, caught: dict):
    """The reference's judgement of the checked mosaic; also the stitch's inputs."""
    img = torch.from_numpy(st.image).to(st.dev)

    def ref_window(i):
        with cpn.exact_fp32():
            return cpn.dense_forward(st.cell.ref, st.weights, st.windows(img, [i]), st.cfg,
                                     cpn.Precision('fp32'))

    with cpn.exact_fp32():
        return judge.judge_mosaic(caught['calls'], caught['final'], ref_window, st.geom, st.cfg,
                                  st.mix)


def nms_timing(st: Mosaic, rows: dict, calls: int = 10) -> dict:
    """The stitch's NMS entry (``nms_chunked`` with the stitch's settings) on the
    checked mosaic's flat rows, timed by CUDA events, and the algorithm's
    least time on them with the reference's keep mask."""
    from celldetection_tpu_torch.ops.boxes import nms_chunked
    boxes, scores, valid = rows['boxes'], rows['scores'], rows['valid']
    thresh, tiled = st.cfg['nms_thresh'], st.tiled

    def once():
        nms_chunked(boxes, scores, valid, thresh, chunk=tiled.nms_chunk, tile=tiled.nms_tile)
    once()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(calls):
        once()
    b.record()
    b.synchronize()
    keep = cpn.greedy_nms(boxes, scores, valid, thresh)
    sb, sv, order = roofline.sorted_inputs(boxes[None], scores[None], valid[None])
    bound, what, tests = roofline.nms_bound(sb, sv, keep[None][:, order[0]], thresh)
    return dict(device_ms=a.elapsed_time(b) / calls, bound_ms=bound, bound_by=what,
                pair_tests=tests)


def run(cell, args, t_start: float) -> dict:
    mix = cell.mix
    st = Mosaic(cell, args.seed)
    pick = int(np.random.default_rng([int(args.seed), 13]).integers(0, mix['check_index']))
    with torch.no_grad():
        st.call()                                     # builds and warms every shape
        harness.reset_peak(st.dev)
        setup_s = time.perf_counter() - t_start
        stats, t_open, t_close, caught = st.loop(args.seconds, pick)
        peak = harness.peak_bytes(st.dev)
        if caught is None:                            # fewer mosaics than the pick: check one more
            caught = st.loop(0., 0)[3]
        window = t_close - t_open
        n = len(stats)
        side = mix['side']
        tiles = n * len(st.geom['offsets'])
        data = dict(kind='mosaic', precision=mix['precision'], peak_bytes=peak,
                    tile_forwards_per_s=tiles / window, stats=stats)
        if args.trace:
            data['trace'] = trace.record(lambda: st.loop(0.))
            from .tiles import cell_flops
            data['flops_per_tile'] = cell_flops(cell)
        kept = len(caught['final']['scores'])
        numbers, rows = check(st, caught)
        if args.trace:
            data['nms'] = nms_timing(st, rows)
        st.model = st.tiled = caught = rows = None
    e2e = dict(mosaic_mpix_per_s=n * side * side / 1e6 / window, setup_s=setup_s)
    return dict(e2e=e2e, attempted=n, failed=0, numbers=numbers, data=data, peak=peak,
                info=dict(mosaics=n, window_s=window, thresh=st.thresh,
                          retried_tiles=sum(s['retried_tiles'] for s in stats),
                          kept=kept))
