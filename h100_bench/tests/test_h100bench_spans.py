"""The per-layer metrics that read the program's spans, and the four-rank mosaic's parts.

Each reader is given a synthetic record (``spans.collect`` replaced) and
must report the mean a request of what it names, and nothing for a run of
another kind or a record without its span. The ``mosaic_ranks`` kind's
reassembly of the ranks' forwards into the one-process call order is held
as a pure function, and a two-rank run of the cell at a small size on the
CPU (``gloo``) is ``correct``.
"""
import importlib.util
import json
import os
import types

import pytest
import torch

from celldetection_tpu_torch.util import spans

from h100_bench import harness
from h100_bench.drivers import mosaic_ranks
from h100_bench.reference import stitch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the four-rank cell's workload entry: its driver, mix and limits are here, and
# BENCHMARK.json takes it once its runs spread less than half the bound
X4 = {"name": "u22_mosaic8k_fp32_b1_x4", "config": "cpn_u22", "traffic": "mosaic8k_fp32_b1_x4",
      "chips": 4, "why": "the 8192x8192 mosaic over 4 ranks on a node's cards: tiles round robin, "
      "local stitches, nccl all_gather of kept rows, final NMS rounds; the exchange exists only "
      "across ranks"}


def _reader(name):
    spec = importlib.util.spec_from_file_location('m_' + name.replace('.', '_'),
                                                  os.path.join(HERE, 'layer_metrics', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _rec(id_, name, parent, request, host_ms, stream_ms=None):
    return dict(name=name, id=id_, parent=parent, request=request, t0_ns=0, t1_ns=0,
                host_ms=host_ms, stream_ms=stream_ms, counts={})


def _tile_records():
    out = []
    for b in range(2):                     # two batches: forwards 10 and 20 apart
        f = 100 * b + 1
        out += [_rec(f + 1, 'cpn.core', f, f, 1., 4. + 2 * b),
                _rec(f + 2, 'cpn.decode', f, f, 1., 2. + 2 * b),
                _rec(f + 4, 'nms.count', f + 3, f, .1, .1),
                _rec(f + 3, 'cpn.nms', f, f, .5, 1. + 2 * b),
                _rec(f, 'cpn.forward', None, f, 10. + 10 * b, 30.)]
    return out


def _mosaic_records():
    out = []
    for m in range(2):
        c = 100 * m + 1
        out += [_rec(c + 1, 'tiled.tile_image', c, c, 100. + 100 * m),
                _rec(c + 2, 'tiled.prepare_inputs', c, c, 40.),
                _rec(c + 3, 'cpn.forward', c + 4, c, 3.),
                _rec(c + 4, 'tiled.forwards', c, c, 500.),
                _rec(c, 'tiled.call', None, c, 700.)]
    return out


def _rank_records():
    c = 1
    return [_rec(2, 'tiled.tile_image', c, c, 100.),
            _rec(9, 'tiled.prepare_inputs', c, c, 20.),
            _rec(3, 'ranks.exchange', c, c, 7.),
            _rec(5, 'nms.exact', 4, c, 2.),
            _rec(6, 'ranks.exchange', 4, c, 3.),
            _rec(7, 'nms.exact', 4, c, 1.),
            _rec(8, 'ranks.exchange', 4, c, 1.),
            _rec(4, 'ranks.final_rounds', c, c, 10.),
            _rec(c, 'ranks.call', None, c, 1000.)]


CASES = [
    ('core_ms.tile', 'tiles', _tile_records, 5.),
    ('decode_ms.tile', 'tiles', _tile_records, 3.),
    ('nms_ms.tile', 'tiles', _tile_records, 2.),
    ('forward_host_ms.tile', 'tiles', _tile_records, 15.),
    ('tiling_ms.mosaic', 'mosaic', _mosaic_records, 150.),
    ('input_ms.mosaic', 'mosaic', _mosaic_records, 40.),
    ('tiling_ms.mosaic', 'mosaic_ranks', _rank_records, 100.),
    ('input_ms.mosaic', 'mosaic_ranks', _rank_records, 20.),
    ('exchange_ms.ranks', 'mosaic_ranks', _rank_records, 11.),
    ('final_nms_ms.ranks', 'mosaic_ranks', _rank_records, 6.),
]


@pytest.mark.parametrize('name,kind,records,want', CASES)
def test_readers_read_their_spans(name, kind, records, want, monkeypatch):
    from celldetection_tpu_torch.util import spans
    read = _reader(name)
    monkeypatch.setattr(spans, 'collect', records)
    assert read({'kind': kind}) == pytest.approx(want)
    others = {'tiles', 'mosaic', 'mosaic_ranks'} - {k for n, k, _, _ in CASES if n == name}
    assert all(read({'kind': k}) is None for k in others)       # another kind of run
    span = {'core_ms.tile': 'cpn.core', 'decode_ms.tile': 'cpn.decode', 'nms_ms.tile': 'cpn.nms',
            'forward_host_ms.tile': 'cpn.forward', 'tiling_ms.mosaic': 'tiled.tile_image',
            'input_ms.mosaic': 'tiled.prepare_inputs', 'exchange_ms.ranks': 'ranks.exchange',
            'final_nms_ms.ranks': 'ranks.final_rounds'}[name]
    monkeypatch.setattr(spans, 'collect', lambda: [r for r in records() if r['name'] != span])
    assert read({'kind': kind}) is None                           # no span of its name
    monkeypatch.setattr(spans, 'collect', lambda: [])
    assert read({'kind': kind}) is None


def _calls(windows, fg, batch):
    """Padded forwards of ``windows`` in batches: each row carries its window
    and the call's capacity, and ``fg_count`` its foreground."""
    out = []
    for s in range(0, len(windows), batch):
        ids = windows[s:s + batch]
        ids = ids + [-1] * (batch - len(ids))                    # the last batch padded
        out.append(dict(window=torch.tensor(ids),
                        fg_count=torch.tensor([fg.get(t, 0) for t in ids]),
                        all_refined=(torch.tensor(ids),), contour_proposals=None))
    return out


@pytest.mark.parametrize('batch', [1, 2])
def test_calls_in_tile_order_is_the_one_process_order(batch):
    tiles, ranks, cap, factor = 11, 4, 10, 8
    fg = {2: 15, 5: 35, 9: 12}                # 2 and 9 retried once, 5 twice (at 20 and 40)
    rank_calls = []
    for r in range(ranks):
        mine = list(range(r, tiles, ranks))
        calls = _calls(mine, fg, batch)
        c = cap
        active = mine
        while True:
            active = [t for t in active if fg.get(t, 0) > c]
            c *= 2
            if not active or c > cap * factor:
                break
            calls += _calls(active, fg, batch)
        rank_calls.append(calls)
    got = mosaic_ranks.calls_in_tile_order(rank_calls, tiles, batch, cap, factor)
    assert [int(c['window'][0]) for c in got] == list(range(tiles)) + [2, 5, 9, 5]
    assert all(c['window'].shape == (1,) and c['all_refined'][0].shape == (1,) for c in got)
    assert got[0]['contour_proposals'] is None
    # what the judge reads back from them: each window's last forward, and the flat order
    per, order = stitch.windows_of_calls(got, tiles, 1, cap, factor)
    assert [int(per[t]['window'][0]) for t in range(tiles)] == list(range(tiles))
    assert order == [t for t in range(tiles) if t not in (2, 5, 9)] + [2, 5, 9]


def test_two_ranks_on_the_cpu_are_correct():
    bench = json.load(open(os.path.join(os.path.dirname(HERE), 'BENCHMARK.json')))
    bench['workloads'].append(X4)
    cell = harness.load_cell(X4['name'], bench, device='cpu')
    cell.mix = dict(cell.mix, side=512, block=256, tile=128, stride=96, fg_max=200, ranks=2)
    cell.cfg = dict(cell.cfg, max_detections=256)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.reset()
    spans.enable()                     # rank 0 records, as under the traced stretch's profiler
    try:
        args = types.SimpleNamespace(seed=2 ** 31 + 11, seconds=0.5, trace=0)
        res = harness.driver(cell).run(cell, args, 0.)
        # the readers that take this kind find rank 0's spans of every mosaic
        read = {m: _reader(m)(res['data']) for m in ('tiling_ms.mosaic', 'input_ms.mosaic',
                                                     'exchange_ms.ranks', 'final_nms_ms.ranks')}
    finally:
        spans.disable()
        spans.reset()
        torch.set_num_threads(n)
    ok, checks = harness.compare(res['numbers'], cell.limits)
    assert ok, checks
    assert res['data']['kind'] == 'mosaic_ranks' and res['attempted'] >= 1
    assert res['info']['ranks'] == 2 and res['info']['kept'] > 0
    assert all(v is not None and v > 0 for v in read.values()), read
