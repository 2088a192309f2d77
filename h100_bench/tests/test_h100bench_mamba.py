"""The Mamba CPN's cell (``rn50mamba_tiles_fp32_b1``) on the CPU at test sizes.

The cell as loaded, with the encoder narrowed (stem 8 channels, so stages of
32-256 channels, Δ's rank still ``'auto'``) and tiles of 64-128: the plain
reference (``reference/cpn_resnet50_unet_mamba.py``) against the program,
its ``init_weights`` against ``mamba_ssm``'s published leaves, its chunked
scan against a plain sequential one, its FLOP count, the two readers of the
Mamba spans, and the check that decides ``correct``: a sound run passes, the
control and a broken scan fail.
"""
import importlib.util
import json
import math
import os
import types

import pytest
import torch

from h100_bench import calibrate, flops, harness, weights
from h100_bench.reference import cpn
from h100_bench.reference import cpn_resnet50_unet_mamba as mamba_ref
from h100_bench.reference import cpn_resnext101_unet as rx101
from h100_bench.tests.test_h100bench_spans import _tile_records

NAME = 'rn50mamba_tiles_fp32_b1'
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PUBLISHED = ('A_log', 'D', 'dt_proj.weight', 'dt_proj.bias')


def small_cell(**mix) -> harness.Cell:
    cell = harness.load_cell(NAME, device='cpu')
    cell.mix = dict(cell.mix, **{**dict(tile=128, pool_side=512, block=256, check_batches=2,
                                        warmup_batches=1), **mix})
    cell.cfg = dict(cell.cfg, stem_channels=8, max_detections=256,
                    backbone_kwargs=dict(cell.cfg['backbone_kwargs'], base_channel=8))
    return cell


def _program(cell, seed=3):
    w = harness.cell_weights(cell, seed)
    return harness.build_program(cell, w), w


def _reader(name):
    spec = importlib.util.spec_from_file_location('m_' + name.replace('.', '_'),
                                                  os.path.join(HERE, 'layer_metrics', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_cell_has_the_published_widths():
    """The Mamba's widths are the source's; its depth, one layer a stage, is listed
    as a cut (``mamba_layers_per_stage`` in ``reduced``), and is what the program builds."""
    cell = harness.load_cell(NAME, device='cpu')
    assert cell.cfg['mamba_layers_per_stage'] == [1, 1, 1, 1]
    with open(os.path.join(os.path.dirname(HERE), 'BENCHMARK.json')) as f:
        entry = next(c for c in json.load(f)['configs'] if c['name'] == cell.entry['config'])
    assert entry['reduced'] == cell.cfg['reduced'] == ['mamba_layers_per_stage']
    shapes = cell.ref.shapes(cell.cfg)
    for i, c in enumerate((256, 512, 1024, 2048)):
        key = f'core.backbone.body.secondary{i + 1}.mamba'
        rank = math.ceil(c / 16)
        assert shapes[f'{key}.x_proj.weight'] == (rank + 32, 2 * c)
        assert shapes[f'{key}.dt_proj.weight'] == (2 * c, rank)
        assert shapes[f'{key}.A_log'] == (2 * c, 16)
        assert shapes[f'{key}.conv1d.weight'] == (2 * c, 1, 4)
    assert cell.entry['chips'] == 1 and cell.mix['precision'] == 'fp32'
    assert cell.mix['tile'] == 1024 and cell.mix['batch'] == 1


def test_shapes_are_the_programs_state():
    cell = small_cell()
    model, _ = _program(cell)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        cell.ref.shapes(cell.cfg)
    body = model.core.backbone.body
    assert [getattr(body, f'secondary{i}').mamba.dt_rank for i in range(1, 5)] == [2, 4, 8, 16]
    per_stage = [sum(1 for k in model.state_dict() if k.startswith(f'core.backbone.body.secondary{i}.')
                     and k.endswith('.A_log')) for i in range(1, 5)]
    assert per_stage == cell.cfg['mamba_layers_per_stage']


@pytest.mark.parametrize('side', [64, 128])
def test_dense_maps_match_program(side):
    cell = small_cell()
    model, w = _program(cell)
    x = torch.rand(1, side, side, 3, generator=torch.Generator().manual_seed(side))
    with torch.no_grad():
        got = model.core(x)
        ref = cpn.dense_forward(cell.ref, w, x, cell.cfg, cpn.Precision('fp32'))
    for key in ('scores', 'locations', 'fourier', 'refinement'):
        assert got[key].shape == ref[key].shape
        # float32 on both sides; another order of summation (the scan's, the convolutions')
        err = float((got[key] - ref[key]).abs().max() / ref[key].abs().max())
        assert err < 1e-5, (key, err)


def test_init_weights_sets_the_published_leaves_alone():
    cell = small_cell()
    shapes = cell.ref.shapes(cell.cfg)
    seed = 2 ** 31 + 7
    got = harness.cell_weights(cell, seed)
    default = weights.make_weights(shapes, seed, 'cpu', cell.cfg['weight_factors'])
    assert list(got) == list(default)
    published = set()
    for i in range(1, 5):
        key = f'core.backbone.body.secondary{i}.mamba'
        d_inner, n, _, rank = mamba_ref.mamba_sizes(cell.cfg, 8 * 4 * 2 ** (i - 1))
        published |= {f'{key}.{leaf}' for leaf in PUBLISHED}
        assert torch.equal(got[f'{key}.A_log'],
                           torch.log(torch.arange(1., n + 1)).expand(d_inner, n))
        assert torch.equal(got[f'{key}.D'], torch.ones(d_inner))
        assert float(got[f'{key}.dt_proj.weight'].abs().max()) <= rank ** -0.5
        dt = torch.nn.functional.softplus(got[f'{key}.dt_proj.bias'].double())
        # softplus undoes the bias to float32 rounding: dt in [1e-3, 1e-1]
        assert float(dt.min()) > 1e-3 * (1 - 1e-5) and float(dt.max()) < 1e-1 * (1 + 1e-5)
    for key in default:
        if key not in published:
            assert torch.equal(got[key], default[key]), key
    assert got.keys() >= published


def _sequential(u, delta, A, B, C, D):
    """The recurrence token by token in float64."""
    u, delta, A, B, C, D = (t.double() for t in (u, delta, A, B, C, D))
    x = u.new_zeros(u.shape[0], u.shape[2], A.shape[1])
    ys = []
    for t in range(u.shape[1]):
        x = torch.exp(delta[:, t, :, None] * A) * x + \
            delta[:, t, :, None] * B[:, t, None, :] * u[:, t, :, None]
        ys.append(torch.einsum('bn,bdn->bd', C[:, t], x))
    return torch.stack(ys, 1) + u * D


@pytest.mark.parametrize('length, chunk', [(1, 32), (45, 32), (100, 7), (64, 1)])
def test_chunked_scan_is_the_sequential_scan(length, chunk):
    g = torch.Generator().manual_seed(length)
    d, n = 6, 16
    u = torch.randn(2, length, d, generator=g)
    # Δ as softplus of the published bias range and larger, A as published: decays
    # from exp(-1e-3) to exp(-16 x 3) a token
    delta = torch.exp(torch.rand(2, length, d, generator=g) * math.log(3e3)) * 1e-3
    A = -torch.arange(1., n + 1).expand(d, n)
    B, C = torch.randn(2, length, n, generator=g), torch.randn(2, length, n, generator=g)
    D = torch.randn(d, generator=g)
    got = mamba_ref.scan(u, delta, A, B, C, D, chunk=chunk)
    want = _sequential(u, delta, A, B, C, D)
    assert got.dtype == torch.float32
    # float32 rounding of sums over up to 1 / (Δ A) tokens, each term O(1)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize('name, dtype', [('fp32', torch.float32), ('bf16', torch.bfloat16)])
def test_the_reference_scans_in_its_precision(name, dtype, monkeypatch):
    """The scan runs in the precision's type: float32 in the comparison, bf16 in the
    control, so the control also stands for a scan of lower precision."""
    cell = small_cell()
    w = harness.cell_weights(cell, 3)
    seen, scan = [], mamba_ref.scan
    monkeypatch.setattr(mamba_ref, 'scan', lambda *a, **k: seen.append({t.dtype for t in a})
                        or scan(*a, **k))
    x = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        out = cpn.dense_forward(cell.ref, w, x, cell.cfg, cpn.Precision(name))
    assert seen == [{dtype}] * 4
    assert all(bool(v.isfinite().all()) for v in out.values())


def test_flops_count_the_mamba_projections_and_convolution():
    cell = small_cell()
    cfg, side = cell.cfg, 64
    got = flops.forward_flops(cell.ref, cfg, 1, side, side)[0]
    without = flops.forward_flops(rx101, cfg, 1, side, side)[0]
    extra = 0
    for i, c in enumerate(rx101.encoder_channels(cfg)[1:]):
        tokens = (side // 2 ** (i + 2)) ** 2
        d_inner, n, d_conv, rank = mamba_ref.mamba_sizes(cfg, c)
        extra += 2 * tokens * (c * 2 * d_inner + d_inner * (rank + 2 * n) + rank * d_inner
                               + d_inner * c + d_inner * d_conv)
    assert got - without == extra


def _mamba_records(tile=1024, batches=2):
    """Two batches' forwards at the cell's widths, each with its four stages'
    mamba.layer spans over a mamba.scan each."""
    out = _tile_records()
    rid = 1000
    for b in range(batches):
        root = 100 * b + 1
        for i in range(4):
            c = 256 * 2 ** i
            counts = dict(batch=1, tokens=(tile // 2 ** (i + 2)) ** 2, d_inner=2 * c, d_state=16,
                          elem_bytes=4)
            out.append(dict(name='mamba.scan', id=rid + 1, parent=rid, request=root, t0_ns=0,
                            t1_ns=0, host_ms=1., stream_ms=10. * (4 - i) + b, counts=counts))
            out.append(dict(name='mamba.layer', id=rid, parent=root + 1, request=root, t0_ns=0,
                            t1_ns=0, host_ms=1., stream_ms=20. * (4 - i) + b, counts={}))
            rid += 2
    return out


def test_readers_read_the_mamba_spans(monkeypatch):
    from celldetection_tpu_torch.util import spans
    layer, roof = _reader('mamba_ms.tile'), _reader('scan_roofline.tile')
    run = {'kind': 'tiles', 'batch': 1}
    monkeypatch.setattr(spans, 'collect', _mamba_records)
    assert layer.read(run) == pytest.approx((200. + 204.) / 2)
    stage_bytes = [4 * (3 * t * di + 2 * t * 16 + di * 16 + di)
                   for t, di in ((65536, 512), (16384, 1024), (4096, 2048), (1024, 4096))]
    bound_ms = 2 * sum(stage_bytes) / 3.35e12 * 1e3
    assert roof.read(run) == pytest.approx(100. * bound_ms / (100. + 104.))
    assert 0.74e9 < sum(stage_bytes) < 0.80e9                   # a tile's fused scans move 0.77 GB
    assert layer.read({'kind': 'mosaic'}) is None and roof.read({'kind': 'mosaic'}) is None
    # scans of other widths are read at their own counts
    monkeypatch.setattr(spans, 'collect', lambda: _mamba_records(tile=512))
    small = [4 * (3 * t * di + 2 * t * 16 + di * 16 + di)
             for t, di in ((16384, 512), (4096, 1024), (1024, 2048), (256, 4096))]
    assert roof.read(run) == pytest.approx(100. * 2 * sum(small) / 3.35e12 * 1e3 / 204.)
    # a U22 run has no Mamba spans
    monkeypatch.setattr(spans, 'collect', _tile_records)
    assert layer.read(run) is None and roof.read(run) is None


def test_spans_of_a_forward_reach_the_readers():
    """The program's own spans of a small forward: one mamba.layer a stage, each over
    one mamba.scan, at the small cell's widths."""
    from celldetection_tpu_torch.util import spans
    cell = small_cell()
    model, _ = _program(cell)
    x = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    spans.reset()
    spans.enable()
    try:
        with torch.no_grad():
            model.forward_padded(x, score_thresh=0., nms=True)
        recs = spans.collect()
        run = {'kind': 'tiles', 'batch': 1}
        layer = _reader('mamba_ms.tile').read(run)
        roof = _reader('scan_roofline.tile').read(run)
    finally:
        spans.disable()
        spans.reset()
    scans = [r for r in recs if r['name'] == 'mamba.scan']
    assert [r['counts']['tokens'] for r in scans] == [256, 64, 16, 4]
    # on the CPU the spans have no stream_ms: the readers read nothing
    assert layer is None and roof is None
    assert all(r['counts']['elem_bytes'] == 4 for r in scans)


def _run(cell, seed=2 ** 31 + 11):
    args = types.SimpleNamespace(seed=seed, seconds=0.5, trace=0)
    res = harness.driver(cell).run(cell, args, 0.)
    return harness.compare(res['numbers'], cell.limits)


def test_a_sound_run_is_correct_and_the_control_is_not():
    cell = small_cell(check_batches=1)
    ok, checks = _run(cell)
    assert ok, checks
    drv = harness.driver(cell)
    state = {}
    calibrate.sound(cell, drv, 5, 0.5, state)
    control = calibrate.control(cell, drv, 5, state)
    assert not harness.compare(control, cell.limits)[0], control


def test_a_scan_without_its_state_is_caught(monkeypatch):
    """The program's scan cut to its skip term ``D u``: the state's part of y is gone."""
    from celldetection_tpu_torch.models import mamba
    monkeypatch.setattr(mamba, 'selective_scan', lambda u, delta, A, B, C, D: u * D)
    ok, checks = _run(small_cell(check_batches=1))
    assert not ok, checks

