"""Traffic kind ``mosaic_ranks``: the ``mosaic`` kind's mosaic split over the
ranks of one machine, one card each, through ``TiledInference(mesh=)``.

The ``run.py`` process is rank 0 on the cell's card; it starts ranks 1 to
``ranks - 1`` on the next cards (``torch.multiprocessing``, a rendezvous on
localhost, ``nccl``; ``gloo`` on the CPU). On cards each rank's intra-op
threads are the host's cores over the ranks, unless ``OMP_NUM_THREADS`` is
set: the ranks share one host, as processes that ``torchrun`` starts do. Every rank draws the seed's
weights and the same mosaic, as a host of a node reads the same slide. Each
call of ``TiledInference`` goes through ``multihost_tiled_inference``:
tiles round robin over the ranks, each rank's forwards and local stitch,
one ``all_gather`` of the kept rows, then the final NMS rounds; every rank
holds the result. The score threshold follows the ``mosaic`` kind's rule,
each rank over its own windows, the largest of theirs taken.

Rank 0 leads: before each mosaic it broadcasts what every rank does next (a
mosaic, a mosaic whose forwards are kept for the check, or stop), so the
loop is the ``mosaic`` kind's: closed, one mosaic at a time, the window
closed at the first mosaic finished after ``--seconds``. For the checked
mosaic each rank keeps its windows' forwards and saves them; rank 0 puts
them back in the one-process call order (:func:`calls_in_tile_order`) and
the reference judges them as it judges one card's. The traced stretch is one
mosaic, profiled on rank 0; the peak memory is rank 0's.

The mix sets what the ``mosaic`` kind's sets and ``ranks``.
"""
import importlib
import os
import shutil
import socket
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import harness, judge, trace
from ..reference import cpn
from .mosaic import Mosaic

STOP, CALL, CHECK = 0, 1, 2


class RankMosaic(Mosaic):
    """One rank's share of the ``mosaic`` kind's state and calls."""

    def __init__(self, cell, seed: int, rank: int, ranks: int, mesh):
        from celldetection_tpu_torch.parallel.mesh import host_group, mesh_group
        self.rank, self.ranks = rank, ranks
        self.host = host_group(mesh_group(mesh))
        super().__init__(cell, seed)
        self.tiled.mesh = mesh

    def threshold(self) -> float:
        """The ``mosaic`` kind's threshold, each rank over its windows, the largest taken."""
        mix, n = self.mix, len(self.geom['offsets'])
        img = torch.from_numpy(self.image).to(self.dev)
        mine = np.arange(self.rank, n, self.ranks)
        cut = -1.
        for s in range(0, len(mine), mix['batch']):
            x = self.windows(img, mine[s:s + mix['batch']])
            out = self.model.forward_padded(x, nms=False)
            p = torch.sigmoid(out['dense_scores'][..., 0].float()).reshape(x.shape[0], -1)
            cut = max(cut, float(torch.topk(p, mix['fg_max'] + 1, 1).values[:, -1].max()))
        t = torch.tensor([cut], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host)
        return float(t[0])

    def call(self, capture: bool = False):
        if self.rank == 0:
            command(self.host, CHECK if capture else CALL)
        return super().call(capture)


def command(host, cmd: int = -1) -> int:
    """Rank 0's next command, broadcast over the host group (rank 0 passes it)."""
    t = torch.tensor([cmd], dtype=torch.int64)
    dist.broadcast(t, src=0, group=host)
    return int(t[0])


def calls_in_tile_order(rank_calls, tiles: int, batch: int, capacity: int, factor: int):
    """One window a call, in the one-process call order, from the ranks' calls.

    ``rank_calls[r]``: rank ``r``'s padded forwards in its call order (its
    windows ``r, r + p, ...`` in batches of ``batch``, then its capacity
    retries: the windows whose foreground exceeds the capacity, again at 2x,
    4x, ... up to ``factor`` x). Returns each window's first forward in
    window order, then the retries level by level, each level in window
    order: the calls one process makes at batch 1.
    """
    p = len(rank_calls)
    first, retries = {}, {}

    def one(out, j):
        return {key: (None if v is None else tuple(x[j:j + 1] for x in v)
                      if isinstance(v, tuple) else v[j:j + 1]) for key, v in out.items()}

    for r, calls in enumerate(rank_calls):
        stream = iter(calls)

        def take(ids):
            got = {}
            for start in range(0, len(ids), batch):
                out = next(stream)
                for j, t in enumerate(ids[start:start + batch]):
                    got[t] = one(out, j)
            return got
        active = list(range(r, tiles, p))
        first.update(take(active))
        cap, level = capacity, 0
        while True:
            active = [t for t in active if int(first[t]['fg_count'][0]) > cap]
            cap, level = cap * 2, level + 1
            if not active or cap > capacity * factor:
                break
            for t, w in take(active).items():
                retries[(level, t)] = w
    return [first[t] for t in range(tiles)] + [retries[k] for k in sorted(retries)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _device(cell, rank: int) -> torch.device:
    dev = cell.device
    return torch.device('cuda', (dev.index or 0) + rank) if dev.type == 'cuda' else dev


def _join(cell, seed: int, rank: int, ranks: int, port: int) -> RankMosaic:
    from celldetection_tpu_torch import parallel
    dev = _device(cell, rank)
    if dev.type == 'cuda' and 'OMP_NUM_THREADS' not in os.environ:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // ranks))
    parallel.initialize_distributed(f'localhost:{port}', ranks, rank, device=dev, timeout=600)
    cell.device = dev
    with torch.no_grad():
        return RankMosaic(cell, seed, rank, ranks, parallel.make_mesh())


def _watch(procs, done):
    """End rank 0's process soon when another rank fails before the run is
    done: rank 0 would otherwise wait for it until the collectives time out."""
    while not done.wait(1.):
        failed = [(r + 1, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
        if failed:
            print(f'mosaic_ranks: ranks ended with (rank, exit code) {failed}', file=sys.stderr,
                  flush=True)
            os._exit(3)


def _saved(tmp: str, rank: int) -> str:
    return os.path.join(tmp, f'rank{rank}.pt')


def follow(rank: int, ranks: int, port: int, entry: dict, mix: dict, cfg: dict, device: str,
           seed: int, tmp: str):
    """Ranks 1 and up: rank 0's commands until it stops them; the checked
    mosaic's forwards saved on the host for rank 0. ``entry`` is the cell's
    workload entry; its limits and metrics are rank 0's alone."""
    ref = importlib.import_module(f"h100_bench.reference.{entry['config']}")
    cell = harness.Cell(entry['name'], entry, cfg, mix, {}, ref, [], [], torch.device(device))
    if cell.device.type == 'cpu':
        torch.set_num_threads(1)
    st = _join(cell, seed, rank, ranks, port)
    try:
        with torch.no_grad():
            while True:
                cmd = command(st.host)
                if cmd == STOP:
                    break
                Mosaic.call(st, capture=cmd == CHECK)
                if cmd == CHECK:
                    calls = [{k: None if v is None else tuple(x.cpu() for x in v)
                              if isinstance(v, tuple) else v.cpu() for k, v in c.items()}
                             for c in st.capture['calls']]
                    torch.save(calls, _saved(tmp, rank))
                    st.capture = None
        dist.barrier(group=st.host)
    finally:
        dist.destroy_process_group()


def check(st: RankMosaic, caught: dict, tmp: str):
    """The reference's judgement of the checked mosaic from every rank's forwards."""
    rank_calls = [caught['calls']] + [torch.load(_saved(tmp, r), map_location=st.dev)
                                      for r in range(1, st.ranks)]
    mix = st.mix
    calls = calls_in_tile_order(rank_calls, len(st.geom['offsets']), mix['batch'],
                                st.cfg['max_detections'], st.geom['factor'])
    img = torch.from_numpy(st.image).to(st.dev)

    def ref_window(i):
        with cpn.exact_fp32():
            return cpn.dense_forward(st.cell.ref, st.weights, st.windows(img, [i]), st.cfg,
                                     cpn.Precision('fp32'))

    with cpn.exact_fp32():
        return judge.judge_mosaic(calls, caught['final'], ref_window, st.geom, st.cfg,
                                  dict(mix, batch=1))[0]


def run(cell, args, t_start: float) -> dict:
    mix = cell.mix
    ranks = mix['ranks']
    port, tmp = _free_port(), tempfile.mkdtemp(prefix='h100_bench_ranks_')
    ctx = torch.multiprocessing.get_context('spawn')
    procs = [ctx.Process(target=follow, daemon=True,
                         args=(r, ranks, port, cell.entry, mix, cell.cfg, str(cell.device),
                               int(args.seed), tmp)) for r in range(1, ranks)]
    for proc in procs:
        proc.start()
    done = threading.Event()
    threading.Thread(target=_watch, args=(procs, done), daemon=True).start()
    try:
        st = _join(cell, args.seed, 0, ranks, port)
        pick = int(np.random.default_rng([int(args.seed), 13]).integers(0, mix['check_index']))
        with torch.no_grad():
            st.call()                                     # builds and warms every shape
            harness.reset_peak(st.dev)
            setup_s = time.perf_counter() - t_start
            stats, t_open, t_close, caught = st.loop(args.seconds, pick)
            peak = harness.peak_bytes(st.dev)
            if caught is None:                            # fewer mosaics than the pick
                caught = st.loop(0., 0)[3]
            window = t_close - t_open
            n = len(stats)
            side = mix['side']
            tiles = n * len(st.geom['offsets'])
            data = dict(kind='mosaic_ranks', precision=mix['precision'], peak_bytes=peak,
                        tile_forwards_per_s=tiles / window, stats=stats, ranks=ranks)
            if args.trace:
                data['trace'] = trace.record(lambda: st.loop(0.))
            command(st.host, STOP)
            dist.barrier(group=st.host)
            kept = len(caught['final']['scores'])
            numbers = check(st, caught, tmp)
            st.model = st.tiled = caught = None
    finally:
        done.set()
        if dist.is_initialized():
            dist.destroy_process_group()
        deadline = time.monotonic() + 120
        for proc in procs:
            proc.join(timeout=max(0., deadline - time.monotonic()))
            if proc.is_alive():
                proc.terminate()
                proc.join()
        shutil.rmtree(tmp, ignore_errors=True)
    failed = [(r + 1, proc.exitcode) for r, proc in enumerate(procs) if proc.exitcode != 0]
    if failed:
        raise RuntimeError(f'mosaic_ranks: ranks ended with (rank, exit code) {failed}')
    e2e = dict(mosaic_mpix_per_s=n * side * side / 1e6 / window, setup_s=setup_s)
    return dict(e2e=e2e, attempted=n, failed=0, numbers=numbers, data=data, peak=peak,
                info=dict(mosaics=n, window_s=window, thresh=st.thresh, ranks=ranks,
                          retried_tiles=sum(s['retried_tiles'] for s in stats), kept=kept))
