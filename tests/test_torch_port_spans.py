"""The port's timing recorder (``util/spans.py``) and the spans of its layers.

Off, a span times its block and records nothing. Under ``torch.profiler``
(or after ``enable()``) each span is also a ``user_annotation`` of the
profiler's trace, and its record lines up with it on the trace's clock;
records nest by ``parent`` and ``request`` as the calls do. A small
CpnU22's ``forward_padded`` records ``cpn.forward`` over ``cpn.core``
(over its ``cpn.head_conv``s), ``cpn.decode`` and ``cpn.nms``;
``TiledInference.stats`` holds its spans' ms. The ``ranks.*`` spans are
held in ``test_torch_port_distributed_infer.py``.
"""
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from celldetection_tpu_torch import models, parallel
from celldetection_tpu_torch.util import spans
from test_torch_port_cpn import one_torch_thread  # noqa: F401  (pytestmark)

pytestmark = pytest.mark.usefixtures('one_torch_thread')


@pytest.fixture
def recorder():
    spans.disable()
    spans.reset()
    yield spans
    spans.disable()
    spans.reset()


@pytest.fixture(scope='module')
def small_u22():
    torch.manual_seed(0)
    return models.CpnU22(in_channels=1, max_detections=64, samples=8, device='cpu',
                         backbone_kwargs=dict(base_channels=8))


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r['name'], []).append(r)
    return out


def test_off_records_nothing(recorder):
    assert not recorder.recording()
    with recorder.span('off', a=1) as s:
        recorder.count('a', 2)
        time.sleep(0.002)
    assert s.ms >= 2. and s.counts == {'a': 1}
    assert recorder.collect() == []


def test_records_line_up_with_the_profiler_trace(recorder, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function('warm-up'):     # the profiler's first annotation sets itself up
            pass
        assert recorder.recording()
        for i in range(3):
            with recorder.span('outer', i=i):
                with recorder.span('inner'):
                    time.sleep(0.001)
                torch.ones(64).sum()
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        trace = json.load(f)
    base = trace.get('baseTimeNanoseconds', 0)
    notes = sorted((e for e in trace['traceEvents'] if e.get('cat') == 'user_annotation'
                    and e['name'] in ('outer', 'inner')), key=lambda e: e['ts'])
    records = sorted(recorder.collect(), key=lambda r: r['t0_ns'])
    assert [r['name'] for r in records] == [e['name'] for e in notes] == ['outer', 'inner'] * 3
    for r, e in zip(records, notes):
        t0, t1 = (r['t0_ns'] - base) / 1e3, (r['t1_ns'] - base) / 1e3   # us, the trace's unit
        assert abs(t0 - e['ts']) < 100 and abs(t1 - (e['ts'] + e['dur'])) < 100, (r, e)
        assert r['host_ms'] == pytest.approx((r['t1_ns'] - r['t0_ns']) * 1e-6)
        assert r['stream_ms'] is None                      # no card in use


def test_parents_and_requests_nest_as_the_calls(recorder):
    recorder.enable()
    with recorder.span('a', n=1) as a:
        recorder.count('n', 2)
        with recorder.span('b'):
            recorder.count('n')
        with recorder.span('c') as c:
            with recorder.span('d'):
                pass
    with recorder.span('e') as e:
        pass
    recorder.disable()
    with recorder.span('off'):
        pass
    rec = {r['name']: r for r in recorder.collect()}
    assert set(rec) == set('abcde')
    assert rec['a']['parent'] is None and rec['a']['request'] == a.id
    assert rec['b']['parent'] == rec['c']['parent'] == a.id
    assert rec['d']['parent'] == c.id and rec['d']['request'] == a.id
    assert rec['e']['parent'] is None and rec['e']['request'] == e.id != a.id
    assert rec['a']['counts'] == {'n': 3} and rec['b']['counts'] == {'n': 1}
    assert rec['a']['host_ms'] == a.ms
    assert recorder.collect() == recorder.collect()        # collect keeps the records
    recorder.reset()
    assert recorder.collect() == []


def test_forward_padded_records_its_layers_in_order(recorder, small_u22):
    x = torch.rand(1, 128, 128, 1)
    recorder.enable()
    with torch.no_grad():
        small_u22.forward_padded(x, score_thresh=0.5, nms=True)
    records = sorted(recorder.collect(), key=lambda r: r['t0_ns'])
    top = records[0]
    layers = [r for r in records if r['parent'] == top['id']]
    assert [r['name'] for r in records[:1] + layers][:4] == ['cpn.forward', 'cpn.core',
                                                             'cpn.decode', 'cpn.nms']
    assert top['parent'] is None and top['counts'] == {'batch': 1, 'k': 64}
    for r in layers[:3]:
        assert r['parent'] == top['id'] and r['request'] == top['id']
        assert top['t0_ns'] <= r['t0_ns'] <= r['t1_ns'] <= top['t1_ns']
    assert layers[1]['counts'] == {'refine_iters': small_u22.refinement_iterations}
    # inside cpn.core: the fused contour heads' conv0, then the refinement head's
    core = layers[0]
    heads = [r for r in records if r['name'] == 'cpn.head_conv']
    c = small_u22.core
    fused = sum(getattr(c, f'{name}_head').conv0.out_channels for name, *_ in c.specs)
    assert [r['counts'] for r in heads] == [
        {'kernel': 0, 'cout': fused},
        {'kernel': 0, 'cout': c.refinement_head.block[0].out_channels}]
    for r in heads:
        assert r['parent'] == core['id'] and r['request'] == top['id']
        assert core['t0_ns'] <= r['t0_ns'] <= r['t1_ns'] <= core['t1_ns']


def test_tiled_stats_are_their_spans_ms(recorder, small_u22):
    image = (np.random.default_rng(0).random((160, 160)) * 255).astype(np.uint8)
    tiled = parallel.TiledInference(small_u22, tile_size=64, stride=48, max_outputs=256)
    recorder.enable()
    with torch.no_grad():
        tiled(image, score_thresh=0.5)
    by = _by_name(recorder.collect())
    stats = tiled.stats
    for key, name in (('forward_ms', 'tiled.forwards'), ('retry_ms', 'tiled.retry'),
                      ('stitch_ms', 'tiled.stitch'), ('readback_ms', 'tiled.readback'),
                      ('total_ms', 'tiled.call')):
        assert [r['host_ms'] for r in by[name]] == [stats[key]], key
    call = by['tiled.call'][0]
    assert call['parent'] is None
    assert by['tiled.tile_image'][0]['counts'] == {'tiles_cut': 9, 'tiles_kept': 9}
    assert by['tiled.prepare_inputs'][0]['counts']['bytes'] == 9 * 64 * 64 + 9 * (8 + 4 + 16)
    fwd = by['tiled.forwards'][0]['id']
    assert sum(r['parent'] == fwd for r in by['cpn.forward']) == 9
    assert by['tiled.retry'][0]['counts'] == {'retried_tiles': stats['retried_tiles']}
    assert all(r['request'] == call['id'] for rs in by.values() for r in rs)
    passes = [p for p in stats['nms'] if 'ms' in p]
    assert [r['host_ms'] for r in by['nms.exact']] == [p['ms'] for p in passes]
    assert by['nms.exact'][0]['counts'] == {'m': passes[0]['m']}
    assert by['tiled.stitch'][0]['counts'] == {'attempts': stats['attempts']}
