#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``celldetection_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvidia-smi`` and ``nvcc`` (on ``PATH``, under
``$CUDA_HOME`` or ``/usr/local/cuda``). Without a card, or without the
package beside it, it exits non-zero before it prints any result.

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit, the torch and CUDA versions;
  2. build every kernel of ``celldetection_tpu_torch/csrc`` for sm_90a and
     print ptxas's registers, shared memory and spills;
  3. every kernel against its plain PyTorch version on the card, requiring
     bit-equal keep masks: batched, large, ragged, tiny, all-invalid and
     knife-edge NMS inputs;
  4. full-width CpnU22 at 256^2 on the card against the same model on the
     CPU, TF32 off;
  5. the main path, ``CPN.forward_padded`` of full-width CpnU22 (backbone,
     heads, decode, refinement, NMS kernel) on 1024^2 tiles, fp32 at batch 1
     and bf16 at batch 4: throughput, a profile of one step (top kernels and
     the slowest convolutions by input shape), peak memory, detections before
     and after NMS, the kernel launches of that run, and the NMS kernel's
     time on that run's boxes.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

import celldetection_tpu_torch as ct
from celldetection_tpu_torch import kernels, models
from celldetection_tpu_torch.kernels.nms import nms_library, nms_sweep
from celldetection_tpu_torch.ops.boxes import _nms_sweep, _suppression_matrix, nms_padded, sort_by_score
from celldetection_tpu_torch.util.weights import init_jax_variables, state_dict_from_jax

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
TILE = 1024          # main-path tile side (the reference CLI's default tile)
CHECK_SIZE = 256     # side of the card-vs-CPU check
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# fp32 operations of one box-pair test (csrc/nms_sweep.cu:suppresses): 4 min/max,
# 2 sub, 2 clamps, inter mul, union add and sub, thresh mul, select, compare.
PAIR_TEST_OPS = 14


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'chip_smoke: {msg}')


def card_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def crowded_boxes(rng, batch, n, extent, invalid=0.05):
    centers = rng.rand(batch, n, 2) * extent
    sizes = rng.rand(batch, n, 2) * 20 + 2
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], -1).astype(np.float32)
    return boxes, rng.rand(batch, n).astype(np.float32), rng.rand(batch, n) > invalid


def knife_edge_pairs(rng, thresh, pairs=512):
    """Pairs whose IoU is exactly ``thresh`` in real arithmetic: a box and its
    own left part of relative width ``thresh``. The first pairs have integer
    corners (10 wide, so the part is 2, 5 or 8 wide); the rest sit at random
    fractional positions. Pairs lie 100 px apart on a grid."""
    gx, gy = np.divmod(np.arange(pairs), 32)
    x = 100. * gx + rng.rand(pairs) * 50
    y = 100. * gy + rng.rand(pairs) * 50
    w = rng.rand(pairs) * 30 + 1
    h = rng.rand(pairs) * 30 + 1
    x[:16], y[:16] = np.floor(x[:16]), np.floor(y[:16])
    w[:16], h[:16] = 10., np.floor(h[:16]) + 1
    a = np.stack([x, y, x + w, y + h], -1)
    b = np.stack([x, y, x + w * thresh, y + h], -1)
    boxes = np.stack([a, b], 1).reshape(1, 2 * pairs, 4).astype(np.float32)
    return boxes, rng.rand(1, 2 * pairs).astype(np.float32), np.ones((1, 2 * pairs), bool)


def nms_bound(b, v, keep, thresh):
    """Least time (ms) for greedy NMS on these score-sorted inputs, and what bounds it.

    Bytes: each box and valid flag read once, the keep mask written once.
    Operations: the pair tests this data needs: a kept box is tested against
    every kept box before it, a suppressed one up to its first kept suppressor.
    """
    bsz, n = v.shape
    nbytes = bsz * n * (16 + 1 + 1)
    tests = 0
    for i in range(bsz):
        k = keep[i]
        ranks = torch.cumsum(k.long(), 0)               # 1-based place among kept rows
        for c0 in range(0, n, 2048):
            c1 = min(n, c0 + 2048)
            sup = _suppression_matrix(b[i], b[i, c0:c1], thresh) & k[:, None]
            sup &= torch.arange(n, device=b.device)[:, None] < torch.arange(c0, c1, device=b.device)
            first = sup.to(torch.uint8).argmax(0)       # first kept suppressor of each column
            kc = k[c0:c1]
            need = torch.where(kc, ranks[c0:c1] - 1, torch.where(sup.any(0), ranks[first], 0))
            tests += int(need[v[i, c0:c1]].sum())
    ops = tests * PAIR_TEST_OPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else 'operations'), tests


def to_dev(arrays, device):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


def threshold_in_gap(probs, lo, hi):
    """A score threshold in the widest gap of the sorted probabilities that
    leaves between ``lo`` and ``hi`` pixels above it; returns (threshold, gap)."""
    s = np.sort(probs.ravel().astype(np.float64))[::-1]
    gaps = s[lo - 1:hi - 1] - s[lo:hi]
    i = lo - 1 + int(np.argmax(gaps))                   # s[i] > t > s[i + 1]
    return float((s[i] + s[i + 1]) / 2), float(gaps.max())


def profile_step(step, label):
    """Where one step's device time goes: ``torch.profiler`` over one call,
    the device kernels' share of the step's wall time, the top kernels and
    the convolutions (input and weight shapes) that take the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device rows named aten::* are the GPU-side spans of operators, which
    # overlap the kernels they launch: counting them too would count twice
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and not e.key.startswith('aten::')),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    print(f'  {label} profile: device kernels {busy:.2f} ms in a {wall_ms:.2f} ms step '
          f'(busy share {busy / wall_ms:.3f}, profiler on)', flush=True)
    for ms, count, key in rows[:12]:
        print(f'    {ms:9.3f} ms  {100 * ms / busy:5.1f}%  x{count:<5d} {key[:90]}', flush=True)
    convs = sorted(((e.device_time_total / 1e3, e.count, e.input_shapes)
                    for e in prof.key_averages(group_by_input_shape=True)
                    if e.key == 'aten::cudnn_convolution' and e.device_type == DeviceType.CPU),
                   key=lambda r: r[0], reverse=True)
    for ms, count, shapes in convs[:3]:
        print(f'    convolution {ms:9.3f} ms  x{count:<3d} input, weight: {shapes[:2]}', flush=True)


def phase_kernels(rng, card):
    """Phase 3: the NMS kernel against its plain version, bit-equal, on the card."""
    print('== phase 3: kernel vs plain on the card (bit-equal keep masks)', flush=True)
    cases = []
    for t in (0.2, 0.5, 0.8):
        cases.append((f'B=4 N=2048 t={t}', crowded_boxes(rng, 4, 2048, 200.), t))
    cases.append(('B=1 N=16384 t=0.5', crowded_boxes(rng, 1, 16384, 800.), 0.5))
    cases.append(('B=2 N=300 t=0.5', crowded_boxes(rng, 2, 300, 100.), 0.5))
    cases.append(('B=1 N=1 t=0.5', crowded_boxes(rng, 1, 1, 10., invalid=0.), 0.5))
    bx, sc, _ = crowded_boxes(rng, 2, 500, 100.)
    cases.append(('B=2 N=500 all invalid t=0.5', (bx, sc, np.zeros((2, 500), bool)), 0.5))
    for t in (0.2, 0.5, 0.8):
        cases.append((f'knife-edge 512 pairs IoU=t={t}', knife_edge_pairs(rng, t), t))
    worst = 0.
    for label, arrays, t in cases:
        boxes, scores, valid = to_dev(arrays, 'cuda')
        _, b, v = sort_by_score(boxes, scores, valid)
        k = nms_sweep(b, v, t)
        p = _nms_sweep(b, v, t)
        end_to_end = nms_padded(boxes, scores, valid, t).cpu()
        cpu = nms_padded(*to_dev(arrays, 'cpu'), t)
        torch.cuda.synchronize()
        diff = int((k != p).sum()) + int((end_to_end != cpu).sum())
        worst = max(worst, float((k.float() - p.float()).abs().max()))
        print(f'  {label}: kept {int(k.sum())} of {int(v.sum())} valid, '
              f'kernel != plain: {int((k != p).sum())}, nms_padded card != cpu: '
              f'{int((end_to_end != cpu).sum())}', flush=True)
        check(diff == 0, f'{label}: kernel and plain keep masks differ')
        check(not bool(end_to_end[~valid.cpu()].any()), f'{label}: an invalid box was kept')
        if label.startswith('B=1 N=16384'):
            big = (b, v, k, t)
    b, v, k, t = big
    ms = cuda_ms(lambda: nms_sweep(b, v, t), 50)
    plain_ms = cuda_ms(lambda: _nms_sweep(b, v, t), 2, warmup=1)
    bound_ms, bound_by, tests = nms_bound(b, v, k, t)
    print(f'  [{card}] nms_sweep B=1 N=16384 t={t}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, '
          f'bound {bound_ms:.6f} ms ({bound_by}; {tests} pair tests), library call: none',
          flush=True)
    return worst


def phase_card_vs_cpu(rng):
    """Phase 4: full-width CpnU22 at 256^2, the card against the CPU, TF32 off."""
    print('== phase 4: CpnU22 (full width) at 256^2, card vs CPU, TF32 off', flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu_m = models.CpnU22(in_channels=3, device='cpu')
    sd = state_dict_from_jax(init_jax_variables(cpu_m, SEED))
    cpu_m.load_state_dict(sd, strict=True)
    gpu_m = models.CpnU22(in_channels=3)
    gpu_m.load_state_dict(sd, strict=True)
    x = torch.from_numpy(rng.rand(1, CHECK_SIZE, CHECK_SIZE, 3).astype(np.float32))
    with torch.no_grad():
        dc = cpu_m.core(x)
        dg = {k: v.cpu() for k, v in gpu_m.core(x.cuda()).items() if v is not None}
    # fp32 convolutions summed in another order by cuDNN and the CPU library,
    # over 22 layers and the 7x7 heads: 1e-3 of each map's magnitude (the
    # refinement map is 3 * tanh of logits many times larger than itself).
    for key, v in dg.items():
        err = float((v - dc[key]).abs().max())
        tol = 1e-3 * max(1., float(dc[key].abs().max()))
        print(f'  dense {key} {tuple(v.shape)}: max |card - cpu| = {err:.3e} (atol {tol:.3e})',
              flush=True)
        check(err <= tol, f'dense {key} differs: {err} > {tol}')
    p_cpu = torch.sigmoid(dc['scores'])
    p_err = float((torch.sigmoid(dg['scores']) - p_cpu).abs().max())
    thresh, gap = threshold_in_gap(p_cpu.numpy(), 500, 2048)
    check(gap > 4 * p_err, f'score gap {gap} too narrow for the card-cpu difference {p_err}')
    outs = {}
    for nms in (False, True):
        oc = cpu_m.forward_padded(x, score_thresh=thresh, nms=nms)
        og = gpu_m.forward_padded(x.cuda(), score_thresh=thresh, nms=nms)
        outs[nms] = (oc, {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in og.items()})
    (pre_c, pre_g), (post_c, post_g) = outs[False], outs[True]

    def pixels(o):
        return set(o['fg_index'][0][o['valid'][0]].tolist())

    check(pixels(pre_c) == pixels(pre_g), 'pre-NMS valid sets differ')
    sym = pixels(post_c) ^ pixels(post_g)
    print(f'  threshold {thresh:.6f} (gap {gap:.2e}, score diff {p_err:.2e}): '
          f'{len(pixels(pre_c))} valid before NMS on both; kept cpu {len(pixels(post_c))}, '
          f'card {len(pixels(post_g))}, differing {len(sym)}', flush=True)
    check(len(sym) <= 0.01 * len(pixels(post_c)), f'{len(sym)} kept boxes differ')
    # contours per selected pixel: the orders may differ on near-equal scores
    cc, cg = pre_c['contours'][0], pre_g['contours'][0]
    ic = {p: i for i, p in enumerate(pre_c['fg_index'][0].tolist())}
    sel = pre_g['valid'][0].nonzero()[:, 0].tolist()
    diffs = torch.stack([(cg[i] - cc[ic[int(pre_g['fg_index'][0][i])]]).abs() for i in sel])
    frac = float((diffs <= 1e-3).all(-1).float().mean())
    print(f'  contours: {100 * frac:.2f}% of points within 1e-3 px, mean |diff| '
          f'{float(diffs.mean()):.2e} px, max {float(diffs.max()):.3f} px', flush=True)
    check(frac >= 0.99 and float(diffs.mean()) < 0.1, 'contours differ beyond the gates')


def main_path(rng, card):
    """Phase 5: full-width CpnU22 on 1024^2 tiles, fp32 batch 1 and bf16 batch 4."""
    print('== phase 5: main path, CpnU22 (full width) on 1024^2 tiles', flush=True)
    torch.backends.cudnn.allow_tf32 = True          # PyTorch's default for fp32 convolutions
    torch.backends.cuda.matmul.allow_tf32 = False   # PyTorch's default for matmuls
    print('  fp32 convolutions in TF32 (cudnn.allow_tf32=True, the PyTorch default)', flush=True)
    configs = []
    sd = None
    for name, dtype, batch in (('fp32', None, 1), ('bf16', torch.bfloat16, 4)):
        m = models.CpnU22(in_channels=3, max_detections=2048, samples=32, compute_dtype=dtype)
        if sd is None:
            sd = state_dict_from_jax(init_jax_variables(m, SEED))
        m.load_state_dict(sd, strict=True)
        x = torch.from_numpy(rng.rand(batch, TILE, TILE, 3).astype(np.float32)).cuda()
        # score threshold from this configuration's own scores: at least
        # 3072 foreground pixels per image, so the NMS sees 2048 valid boxes
        probs = torch.sigmoid(m.forward_padded(x, nms=False)['dense_scores'].float())
        q = torch.quantile(probs.reshape(batch, -1).cpu().double(),
                           1 - 3072 / probs[0].numel(), dim=1)
        configs.append((name, m, x, float(q.min())))

    for k in kernels.KERNELS:          # the main path's run: counts from 0
        k.launches = 0
    runs = []
    for name, m, x, thresh in configs:
        before = nms_sweep.launches
        pre = m.forward_padded(x, score_thresh=thresh, nms=False)
        out = m.forward_padded(x, score_thresh=thresh)
        res = m(x, score_thresh=thresh)               # the user API: ragged per-image results
        torch.cuda.synchronize()
        runs.append((name, m, x, thresh, pre, out, res, nms_sweep.launches - before))
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    print(f'  kernel launches in the main path run: {launches}', flush=True)
    check(all(n > 0 for n in launches.values()), 'a kernel of the path was never launched')

    kernel_rec = None
    for name, m, x, thresh, pre, out, res, delta in runs:
        batch = x.shape[0]
        n_pre = pre['valid'].sum(1).tolist()
        n_post = out['valid'].sum(1).tolist()
        check(delta > 0, f'{name}: NMS kernel not launched')
        check(all(n == 2048 for n in n_pre), f'{name}: NMS saw {n_pre} valid boxes, not 2048')
        check(all(n >= 1 for n in n_post), f'{name}: no box kept')
        check([len(c) for c in res['contours']] == n_post, f'{name}: ragged results disagree')
        for key in ('contours', 'boxes', 'scores', 'fourier', 'locations'):
            check(bool(torch.isfinite(out[key]).all()), f'{name}: non-finite {key}')
        check(tuple(out['contours'].shape) == (batch, 2048, 32, 2), f'{name}: contour shape')

        # throughput: host clock around forwards that end in reading the results back
        def step():
            o = m.forward_padded(x, score_thresh=thresh)
            return o['boxes'].cpu(), o['scores'].cpu(), o['valid'].cpu()

        for _ in range(2):
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        iters = 10
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / iters
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        profile_step(step, f'[{card}] {name} batch {batch}')

        # the NMS kernel on this run's own inputs, against its plain version
        _, b, v = sort_by_score(pre['boxes'], pre['scores'], pre['valid'])
        k = nms_sweep(b, v, m.nms_thresh)
        p = _nms_sweep(b, v, m.nms_thresh)
        err = float((k.float() - p.float()).abs().max())
        check(err == 0., f'{name}: kernel and plain keep masks differ on the main path inputs')
        ms = cuda_ms(lambda: nms_sweep(b, v, m.nms_thresh), 200)
        plain_ms = cuda_ms(lambda: _nms_sweep(b, v, m.nms_thresh), 3, warmup=1)
        bound_ms, bound_by, tests = nms_bound(b, v, k, m.nms_thresh)
        print(f'  [{card}] {name} batch {batch}: {batch / dt:.3f} tiles/s '
              f'({1e3 * dt:.2f} ms per forward incl. readback), peak memory '
              f'{peak:.2f} GiB, threshold {thresh:.6f}, valid before NMS {n_pre}, after {n_post}, '
              f'NMS launches {delta}', flush=True)
        print(f'  [{card}] {name} nms_sweep B={batch} N=2048: kernel {ms:.4f} ms, plain '
              f'{plain_ms:.3f} ms, bound {bound_ms:.6f} ms ({bound_by}; {tests} pair tests), '
              f'library call: none (no single PyTorch call computes greedy NMS)', flush=True)
        if name == 'bf16':
            kernel_rec = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                              max_abs_err=err)
    return launches, kernel_rec


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available', file=sys.stderr)
        return 1
    check(os.path.dirname(os.path.abspath(ct.__file__)) == os.path.join(HERE, 'celldetection_tpu_torch'),
          f'the port was imported from {ct.__file__}, not from this checkout')

    t_start = time.perf_counter()
    print('== phase 1: device', flush=True)
    card = card_line()
    print(card, flush=True)
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}, '
          f'{torch.cuda.device_count()} device(s): {torch.cuda.get_device_name(0)}', flush=True)
    check(torch.cuda.device_count() >= 1, 'no card')

    print('== phase 2: build the kernels', flush=True)
    built = nms_library()
    print(f'  {os.path.relpath(built.path, HERE)}: built in {built.build_seconds:.2f} s '
          f'(0 = reused)\n{built.log.strip()}', flush=True)

    rng = np.random.RandomState(SEED)
    worst = phase_kernels(rng, card)
    phase_card_vs_cpu(rng)
    launches, rec = main_path(rng, card)
    check('jax' not in sys.modules and 'celldetection_tpu' not in sys.modules,
          'JAX or the JAX package was imported')
    print(f'total {time.perf_counter() - t_start:.1f} s', flush=True)
    record = {'kernels': [{
        'name': 'nms_sweep', 'route': 'cuda',
        'source': 'celldetection_tpu_torch/csrc/nms_sweep.cu',
        'replaces': 'celldetection_tpu/kernels/nms_pallas.py:59',
        'launches': launches['nms_sweep'], 'max_abs_err': max(worst, rec['max_abs_err']),
        'ms': rec['ms'], 'plain_ms': rec['plain_ms'], 'bound_ms': rec['bound_ms'],
        'bound_by': rec['bound_by'], 'library_ms': None}]}
    print(card, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
