#!/usr/bin/env python3
"""Data-parallel training and a multi-process mosaic over the cards of one machine.

Runs one rank, then ``--ranks`` ranks (every visible card by default), each
rank a process on its own card over ``nccl``:

(a) the training step of ``scripts/bench_train.py``'s workload (full-width
    CpnU22, one channel, 256^2, 4 images a rank, K = 512, Adam 5e-4):
    imgs/s and ms a step over 20 timed steps, the gradient all-reduce alone
    (ms, bytes), peak memory a rank; the ranks' parameters bit-identical;
(b) ``TiledInference`` of ``chip_smoke.py`` phase 7's 8192^2 blob mosaic in
    fp32 at batch 1 (tile 1024, stride 768, its spread heads and
    threshold), split over the ranks by ``multihost_tiled_inference``:
    tiles/s, ms by stage, bytes exchanged; the result the same on every
    rank and bit-equal to one rank's.

Prints the card's name and power limit, then one JSON line per rank count.
Run from the repository root: ``python3 scripts/torch_ddp_scaling.py
[--ranks N]``; with ``--cpu`` it rehearses on the CPU over ``gloo`` at a
small size (CpnU22 at base 8, a 512^2 mosaic in 256^2 tiles).
"""
import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
from celldetection_tpu_torch import models, parallel  # noqa: E402
from celldetection_tpu_torch.util.config import conf2optimizer  # noqa: E402

TIMED_STEPS = 20


def sizes(cpu):
    """(training crop, mosaic side, tile, stride, backbone kwargs)."""
    if cpu:
        return 64, 512, 256, 192, dict(base_channels=8)
    return cs.TRAIN_SIZE, 8192, cs.TILE, 768, {}


def sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def train(cfg, dev, rank, n, mesh):
    """(a) on this rank: the timed steps and the all-reduce alone."""
    crop, _, _, _, bk = sizes(cfg['cpu'])
    pairs = cs.disk_images(4 * n, crop, cs.SEED)
    batch = cs.train_batch(pairs, cs.TRAIN['samples'], cs.SEED)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[4 * rank:4 * rank + 4])).to(dev)
             for k, v in batch.items()}
    model = models.CpnU22(in_channels=1, device=dev, backbone_kwargs=bk, **cs.TRAIN)
    model.load_state_dict(cs.random_weights(model), strict=True)
    state = parallel.TrainState.create(model, conf2optimizer({'Adam': {'lr': 5e-4}}))
    step = parallel.make_train_step(model, state.optimizer, mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + rank)
    for _ in range(2):
        step(state, batch, gen)
    sync(dev)
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(dev)
    if mesh is not None:
        torch.distributed.barrier()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        step(state, batch, gen)
    sync(dev)
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    out = dict(train_step_ms=step_s * 1e3, train_imgs_s=4 * n / step_s,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30 if dev.type == 'cuda'
               else None, params_digest=cs.params_digest(model))
    numel = sum(p.numel() for p in model.parameters())
    out['allreduce_bytes'] = 4 * numel
    if mesh is not None:
        flat = torch.zeros(numel, device=dev)
        torch.distributed.all_reduce(flat)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(5):
            torch.distributed.all_reduce(flat)
        sync(dev)
        out['allreduce_ms'] = (time.perf_counter() - t0) / 5 * 1e3
    return out


def mosaic_model(cfg, dev):
    _, side, tile, stride, bk = sizes(cfg['cpu'])
    model = models.CpnU22(in_channels=1, max_detections=2048, samples=32, device=dev,
                          backbone_kwargs=bk)
    model.load_state_dict(cs.random_weights(model, score=0.25, fourier=0.1), strict=True)
    mosaic = np.ascontiguousarray(cs.blob_mosaic(2 * side, block=min(side, 1024))[:side, :side])
    return model, mosaic, tile, stride


def tiles(cfg, dev, mesh, thresh):
    """(b) on this rank: the mosaic split over the mesh's ranks (one rank: the
    single-process ``TiledInference``)."""
    model, mosaic, tile, stride = mosaic_model(cfg, dev)
    tiled = parallel.TiledInference(model, tile_size=tile, stride=stride, batch_size=1,
                                    max_outputs=400_000, mesh=mesh)
    tiled(mosaic[:2 * tile, :2 * tile], score_thresh=thresh)      # warm-up
    sync(dev)
    if mesh is not None:
        torch.distributed.barrier()
    t0 = time.perf_counter()
    res = tiled(mosaic, score_thresh=thresh)
    seconds = time.perf_counter() - t0
    st = tiled.stats
    stages = {k: st[k] for k in ('forward_ms', 'retry_ms', 'stitch_ms', 'exchange_ms',
                                 'final_nms_ms', 'readback_ms') if k in st}
    return res, dict(tiles_s=res['num_tiles'] / seconds, mosaic_s=seconds, stage_ms=stages,
                     exchange_bytes=st.get('exchange_bytes'), rounds=st.get('rounds'),
                     restored=st.get('restored'), kept=res['num_valid'],
                     tiles=res['num_tiles'])


def rank_main(rank, port, n, cfg, tmp):
    dev = torch.device('cpu' if cfg['cpu'] else f'cuda:{rank}')
    if cfg['cpu']:
        torch.set_num_threads(1)
    parallel.initialize_distributed(f'localhost:{port}', n, rank, device=dev, timeout=600)
    try:
        mesh = parallel.make_mesh()
        out = train(cfg, dev, rank, n, mesh)
        res, out['tiles'] = tiles(cfg, dev, mesh, cfg['thresh'])
        torch.save(dict(out=out, res=res), os.path.join(tmp, f'rank{rank}.pt'))
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


def threshold(cfg, dev):
    """Phase 7's: at most 2000 foreground pixels in every tile of the mosaic."""
    model, mosaic, tile, stride = mosaic_model(cfg, dev)
    tiled = parallel.TiledInference(model, tile_size=tile, stride=stride)
    tiles_np = parallel.tile_image(mosaic, tile, stride)[0]
    return cs.spread_thresholds({'fp32': tiled}, tiles_np)['fp32'] if not cfg['cpu'] else \
        float(np.quantile(torch.sigmoid(model.forward_padded(
            torch.from_numpy(tiles_np[:4]), nms=False)['dense_scores']).numpy(), 0.97))


def main():
    import torch.multiprocessing as mp
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--ranks', type=int, default=None, help='ranks of the second run (all cards)')
    p.add_argument('--cpu', action='store_true', help='rehearse on the CPU over gloo')
    args = p.parse_args()
    cfg = dict(cpu=args.cpu)
    if args.cpu:
        torch.set_num_threads(1)
        dev = torch.device('cpu')
        n = args.ranks or 4
    else:
        if not torch.cuda.is_available():
            print('torch_ddp_scaling: no CUDA device is available', file=sys.stderr)
            return 1
        print(cs.card_line(), flush=True)
        for load in (cs.bits_library, cs.resolve_library):     # built once, before the ranks
            load()
        dev = torch.device('cuda:0')
        n = args.ranks or torch.cuda.device_count()
    torch.backends.cudnn.allow_tf32 = True        # as chip_smoke.py phases 7 and 11b
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg['thresh'] = threshold(cfg, dev)

    one = train(cfg, dev, 0, 1, None)
    res1, one['tiles'] = tiles(cfg, dev, None, cfg['thresh'])
    print(json.dumps(dict(ranks=1, **one)), flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(rank_main, args=(cs.free_port(), n, cfg, tmp), nprocs=n,
                           start_method='spawn')
        outs = [torch.load(os.path.join(tmp, f'rank{r}.pt'), weights_only=False)
                for r in range(n)]
    first = outs[0]['res']
    same = all(cs.same_result(o['res'], first) for o in outs)
    digests = {o['out']['params_digest'] for o in outs}
    out = dict(outs[0]['out'], ranks=n, same_across_ranks=same, params_same=len(digests) == 1,
               equal_to_one_rank=cs.same_result(first, res1),
               tiles_by_rank=[o['out']['tiles']['stage_ms'] for o in outs])
    print(json.dumps(out), flush=True)
    ok = same and len(digests) == 1 and out['equal_to_one_rank']
    if not ok:
        print('torch_ddp_scaling: the ranks disagree, or differ from one rank', file=sys.stderr)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
