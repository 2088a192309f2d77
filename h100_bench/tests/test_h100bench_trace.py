"""The reduction of a profiler trace: busy time, idle gaps by host label, conv share."""
import sys
import types

import pytest

from h100_bench import harness, trace


def _x(name, cat, ts, dur, tid=1, **args):
    e = dict(ph='X', name=name, cat=cat, ts=ts, dur=dur, tid=tid)
    if args:
        e['args'] = args
    return e


def test_reduce_a_small_trace():
    events = [
        _x(trace.WINDOW, 'user_annotation', 0, 100),
        _x('h100_bench.dispatch', 'user_annotation', 0, 60),
        _x('aten::convolution', 'cpu_op', 1, 10),
        _x('aten::cudnn_convolution', 'cpu_op', 2, 8),
        _x('cudaLaunchKernel', 'cuda_runtime', 3, 1, correlation=1),
        _x('aten::add', 'cpu_op', 20, 5),
        _x('cudaLaunchKernel', 'cuda_runtime', 21, 1, correlation=2),
        _x('aten::item', 'cpu_op', 70, 20),
        _x('sm90_xmma_gemm_f32', 'kernel', 10, 30, tid=7, correlation=1),
        _x('elementwise_add', 'kernel', 40, 10, tid=7, correlation=2),
        _x('Memcpy DtoH', 'gpu_memcpy', 80, 5, tid=7),
    ]
    out = trace.reduce(events)
    assert out['window_s'] == pytest.approx(100e-6)
    assert out['busy_s'] == pytest.approx(45e-6)
    assert out['conv_s'] == pytest.approx(30e-6)         # by its launching op, not its name
    gaps = dict(out['idle_gaps'])
    # a gap is labelled by what the host was in at its start: 0-10 and 50-80
    # inside the dispatch span, 85-100 inside aten::item
    assert gaps['h100_bench.dispatch'] == pytest.approx(40e-6)
    assert gaps['aten::item'] == pytest.approx(15e-6)
    assert sum(gaps.values()) == pytest.approx(55e-6)
    assert out['device_ops'][0] == ['sm90_xmma_gemm_f32', pytest.approx(30e-6)]


def test_no_device_events_reads_no_busy_time():
    out = trace.reduce([_x(trace.WINDOW, 'user_annotation', 0, 100)])
    assert 'busy_s' not in out


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'celldetection_tpu_torch_fake', types.ModuleType('x'))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, 'jax.numpy', types.ModuleType('jax.numpy'))
    assert harness.forbidden_modules() == ['jax']
