"""The ConvNeXt-Large CPN's cell (``cnxl_tiles_bf16_b4``) on the CPU at test sizes.

The configuration at its published widths where only shapes are needed (the
program built on the ``meta`` device), and otherwise with the encoder
narrowed (depths 2, 1, 3, 1 at 32-128 channels, built by the program's own
``_make_cpn`` in the registry's place) on tiles of 64-128: the plain reference
(``reference/cpn_convnext_large_unet.py``) against the program, its
``init_weights``, its fp8 linears, its FLOP count, the two readers of the
``convnext.stage`` spans, and the check that decides ``correct``: a sound run
passes, the fp8 control and a block without its MLP fail.
"""
import importlib.util
import json
import math
import os
import types

import pytest
import torch
import torch.nn.functional as F

from h100_bench import calibrate, flops, harness, weights
from h100_bench.reference import cpn
from h100_bench.reference import cpn_convnext_large_unet as cnx
from h100_bench.tests.test_h100bench_spans import _tile_records

NAME = 'cnxl_tiles_bf16_b4'
MODEL = 'CpnConvNeXtLargeUNet'
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(depths=[2, 1, 3, 1], channels=[32, 64, 96, 128])


@pytest.fixture
def narrow(monkeypatch):
    """The registry's ``CpnConvNeXtLargeUNet`` built with :data:`NARROW`'s encoder."""
    from celldetection_tpu_torch.models import convnext, cpn as port_cpn, unet
    backbone = unet._backbone_unet(convnext._convnext(tuple(NARROW['depths']),
                                                      tuple(NARROW['channels'])))

    def ctor(in_channels, backbone_kwargs=None, **kwargs):
        return port_cpn._make_cpn(backbone, in_channels, backbone_kwargs, name=MODEL, **kwargs)
    monkeypatch.setitem(port_cpn.models_by_name, MODEL, ctor)


def small_cell(precision='bf16', **mix) -> harness.Cell:
    cell = harness.load_cell(NAME, device='cpu')
    cell.mix = dict(cell.mix, **{**dict(tile=128, pool_side=512, block=256, check_batches=1,
                                        warmup_batches=1, batch=2, precision=precision), **mix})
    cell.cfg = dict(cell.cfg, max_detections=256, **NARROW)
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
    """Depths, widths, the block's norm and MLP as published, nothing cut; the
    reference's parameters are the program's state at full width."""
    from celldetection_tpu_torch.models import cpn as port_cpn
    cell = harness.load_cell(NAME, device='cpu')
    cfg = cell.cfg
    assert cfg['model'] == MODEL and cfg['depths'] == [3, 3, 27, 3]
    assert cfg['channels'] == [192, 384, 768, 1536]
    with open(os.path.join(os.path.dirname(HERE), 'BENCHMARK.json')) as f:
        entry = next(c for c in json.load(f)['configs'] if c['name'] == cell.entry['config'])
    assert entry['reduced'] == cfg['reduced'] == []
    assert cell.entry['chips'] == 1 and cell.mix['precision'] == 'bf16'
    assert cell.mix['tile'] == 1024 and cell.mix['batch'] == 4
    with torch.device('meta'):
        model = port_cpn.get_cpn(MODEL)(3, device='meta', torch_init=False)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == cell.ref.shapes(cfg)
    body = model.core.backbone.body
    block = body.stage2_block26
    assert block.norm.eps == cnx.LN_EPS == 1e-6 and block.mlp0.out_features == 4 * 768
    assert not hasattr(body, 'stage2_block27') and body.fused_initial
    assert model.core.backbone.unet.bridges == 2


def test_shapes_are_the_programs_state(narrow):
    cell = small_cell()
    model, _ = _program(cell)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        cell.ref.shapes(cell.cfg)


@pytest.mark.parametrize('side', [64, 128])
def test_dense_maps_match_program(narrow, side):
    cell = small_cell(precision='fp32')
    model, w = _program(cell)
    x = torch.rand(1, side, side, 3, generator=torch.Generator().manual_seed(side))
    with torch.no_grad():
        got = model.core(x)
        ref = cpn.dense_forward(cell.ref, w, x, cell.cfg, cpn.Precision('fp32'))
    for key in ('scores', 'locations', 'fourier', 'refinement'):
        assert got[key].shape == ref[key].shape
        # float32 on both sides, the same operations; the program's channels-last
        # copies around the norms and MLPs may sum in another order. Sound reads
        # ~3e-7 at 128^2; LayerNorm epsilon 1e-5 in the encoder reads ~6e-6 and
        # the tanh GELU ~1e-4, so both are caught here
        err = float((got[key] - ref[key]).abs().max() / ref[key].abs().max())
        assert err < 2e-6, (key, err)


def test_bf16_dense_maps_are_near_the_program(narrow):
    """The program's bf16 path and the reference's bf16 run: both round every
    activation to bf16 (8 bits of mantissa), in other orders, so the score logits
    agree to a few bf16 steps of their spread, and far better than to the fp8 control."""
    cell = small_cell()
    model, w = _program(cell)
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        got = model.forward_padded(x, score_thresh=0., nms=False)['dense_scores'][..., 0]
        want = cpn.dense_forward(cell.ref, w, x, cell.cfg, cpn.Precision('fp32'))['scores']
        bf16 = cpn.dense_forward(cell.ref, w, x, cell.cfg, cpn.Precision('bf16'))['scores']
        fp8 = cpn.dense_forward(cell.ref, w, x, cell.cfg, cpn.Precision('fp8'))['scores']
    spread = want.std()
    gap = float((got.float() - want[..., 0]).abs().max() / spread)
    assert gap < 0.1, gap
    assert float((bf16 - want).abs().max() / spread) < 0.1
    assert float((fp8 - want).abs().max() / spread) > 2 * gap


def test_init_weights_sets_only_the_layer_scales():
    cell = small_cell()
    shapes = cell.ref.shapes(cell.cfg)
    seed = 2 ** 31 + 7
    got = harness.cell_weights(cell, seed)
    default = weights.make_weights(shapes, seed, 'cpu', cell.cfg['weight_factors'])
    assert list(got) == list(default)
    scales = {k for k in shapes if k.endswith('.layer_scale')}
    assert len(scales) == sum(NARROW['depths'])
    lo, hi = cnx.LAYER_SCALE
    for key in default:
        if key in scales:
            assert float(got[key].min()) >= lo and float(got[key].max()) <= hi, key
            assert float(got[key].std()) > 0
        else:
            assert torch.equal(got[key], default[key]), key


def test_linear_quantises_both_operands_under_fp8():
    g = torch.Generator().manual_seed(0)
    x, w, b = torch.randn(3, 5, 64, generator=g), torch.randn(32, 64, generator=g), \
        torch.randn(32, generator=g)
    exact = F.linear(x, w, b)
    with cpn.exact_fp32():
        assert torch.equal(cnx.linear(x, w, b, cpn.Precision('fp32')), exact)
    xq, sx = cpn._fp8(x)
    wq, sw = cpn._fp8(w)
    fp8 = cnx.linear(x, w, b, cpn.Precision('fp8'))
    assert fp8.dtype == torch.bfloat16
    assert torch.equal(fp8, (F.linear(xq, wq) * (sx * sw) + b).bfloat16())
    # e4m3 keeps 3 bits of mantissa: the products part from the exact ones by ~1e-2
    assert 1e-3 < float((fp8.float() - exact).abs().max() / exact.abs().max()) < 0.2
    assert cnx.linear(x.bfloat16(), w, b, cpn.Precision('bf16')).dtype == torch.bfloat16


def _encoder_flops(cfg, side):
    """FLOPs by hand: per position the stem's or downsample's conv, each block's
    depthwise 7x7 and (apart) its MLP's two matmuls."""
    convs = mlp = 0
    prev = cfg['in_channels']
    for i, (depth, c) in enumerate(zip(cfg['depths'], cfg['channels'])):
        tokens = (side // 2 ** (i + 2)) ** 2
        k = 4 if i == 0 else 2
        convs += 2 * tokens * c * prev * k * k + depth * tokens * 2 * 49 * c
        mlp += depth * tokens * 16 * c * c
        prev = c
    return convs, mlp


def test_flops_count_the_mlp_matmuls():
    cell = small_cell()
    cfg, side = cell.cfg, 128
    total, by = flops.forward_flops(cell.ref, cfg, 1, side, side)
    convs, mlp = _encoder_flops(cfg, side)
    assert total - sum(n for *_, n in by) == mlp
    depthwise = [n for w, o, n in by if w[1:] == (1, 7, 7)]
    assert len(depthwise) == sum(cfg['depths'])
    encoder = [n for w, o, n in by if w[1:] == (1, 7, 7) or w[2:] in ((4, 4), (2, 2))]
    assert sum(encoder) == convs


def test_flops_of_a_full_width_tile():
    """≈11.1 TFLOP a 1024^2 tile, of it 1.39 the MLPs' and 6.6 the two 7x7 heads'."""
    cfg = harness.load_cell(NAME, device='cpu').cfg
    total, by = flops.forward_flops(cnx, cfg, 1, 1024, 1024)
    mlp = _encoder_flops(cfg, 1024)[1]
    heads = sum(n for w, o, n in by if w[2:] == (7, 7) and w[1] == 192)
    assert mlp == pytest.approx(1.39e12, rel=0.01)
    assert heads == 2 * 49 * 192 * (3 * 192 * 512 ** 2 + 192 * 1024 ** 2)
    assert total == pytest.approx(11.14e12, rel=0.01)


# the cell's stages on 1024^2 tiles, batch 4: (tokens, channels, in_channels, blocks)
STAGES = [(65536, 192, 3, 3), (16384, 384, 192, 3), (4096, 768, 384, 27), (1024, 1536, 768, 3)]


def _stage_records(batches=2, stream=(10., 8., 30., 6.)):
    out = _tile_records()
    rid = 1000
    for b in range(batches):
        root = 100 * b + 1
        for i, (tokens, c, cin, blocks) in enumerate(STAGES):
            counts = dict(stage=i, batch=4, tokens=tokens, channels=c, in_channels=cin,
                          blocks=blocks, elem_bytes=2)
            out.append(dict(name='convnext.stage', id=rid, parent=root + 1, request=root,
                            t0_ns=0, t1_ns=0, host_ms=1., stream_ms=stream[i] + b,
                            counts=counts))
            rid += 1
    return out


def test_readers_read_the_convnext_spans(monkeypatch):
    from celldetection_tpu_torch.util import spans
    layer, roof = _reader('convnext_ms.tile'), _reader('convnext_roofline.tile')
    run = {'kind': 'tiles', 'batch': 4}
    monkeypatch.setattr(spans, 'collect', _stage_records)
    assert layer.read(run) == pytest.approx((54. + 58.) / 2)
    flops_ms, bytes_ms = [], []
    for i, (tokens, c, cin, blocks) in enumerate(STAGES):
        k = 4 if i == 0 else 2
        fl = 4 * tokens * (blocks * (98 * c + 16 * c * c) + 2 * c * cin * k * k)
        by = 2 * (blocks * (2 * 4 * tokens * c + 8 * c * c + 58 * c)
                  + 4 * tokens * (k * k * cin + c) + c * cin * k * k + c + 2 * cin)
        flops_ms.append(fl / 989e12 * 1e3)
        bytes_ms.append(by / 3.35e12 * 1e3)
    # every stage of ConvNeXt-Large is bound by its FLOPs at batch 4 in bf16
    assert all(f > b for f, b in zip(flops_ms, bytes_ms))
    assert sum(flops_ms) == pytest.approx(5.81, rel=0.01)       # ms a batch of four tiles
    assert roof.read(run) == pytest.approx(100. * 2 * sum(flops_ms) / (54. + 58.))
    # stages faster than their bound would read above 100%: the bound is a least time
    monkeypatch.setattr(spans, 'collect', lambda: _stage_records(stream=(.1, .1, .1, .1)))
    assert roof.read(run) > 100.
    assert layer.read({'kind': 'mosaic'}) is None and roof.read({'kind': 'mosaic'}) is None
    # a U22 run has no ConvNeXt spans
    monkeypatch.setattr(spans, 'collect', _tile_records)
    assert layer.read(run) is None and roof.read(run) is None


def test_bytes_bound_a_stage_in_fp32_at_batch_one():
    """At batch 1 in fp32 (TF32's peak) the bound still takes the larger time,
    and a stage of few channels over many tokens is bound by its bytes."""
    roof = _reader('convnext_roofline.tile')
    counts = dict(stage=0, batch=1, tokens=65536, channels=8, in_channels=3, blocks=3,
                  elem_bytes=4)
    fl = roof.stage_flops(**counts) / 495e12 * 1e3
    by = roof.stage_bytes(**counts) / 3.35e12 * 1e3
    assert by > fl and roof.least_ms(counts) == by


def test_spans_of_a_forward_reach_the_readers(narrow):
    """The program's own spans of a small forward: one convnext.stage a stage
    inside cpn.core, at the narrow cell's widths."""
    from celldetection_tpu_torch.util import spans
    cell = small_cell()
    model, _ = _program(cell)
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    spans.reset()
    spans.enable()
    try:
        with torch.no_grad():
            model.forward_padded(x, score_thresh=0., nms=True)
        recs = spans.collect()
        run = {'kind': 'tiles', 'batch': 2}
        layer = _reader('convnext_ms.tile').read(run)
        roof = _reader('convnext_roofline.tile').read(run)
    finally:
        spans.disable()
        spans.reset()
    core = next(r for r in recs if r['name'] == 'cpn.core')
    stages = [r for r in recs if r['name'] == 'convnext.stage']
    assert [r['parent'] for r in stages] == [core['id']] * 4
    assert [r['counts'] for r in stages] == [
        dict(stage=i, batch=2, tokens=(16 // 2 ** i) ** 2, channels=c,
             in_channels=([3] + NARROW['channels'])[i], blocks=d, elem_bytes=2)
        for i, (d, c) in enumerate(zip(NARROW['depths'], NARROW['channels']))]
    # on the CPU the spans have no stream_ms: the readers read nothing
    assert layer is None and roof is None


def _run(cell, seed=2 ** 31 + 11):
    args = types.SimpleNamespace(seed=seed, seconds=0.5, trace=0)
    res = harness.driver(cell).run(cell, args, 0.)
    return harness.compare(res['numbers'], cell.limits)


def test_a_sound_run_is_correct_and_the_control_is_not(narrow):
    cell = small_cell()
    ok, checks = _run(cell)
    assert ok, checks
    drv = harness.driver(cell)
    state = {}
    calibrate.sound(cell, drv, 5, 0.5, state)
    control = calibrate.control(cell, drv, 5, state)
    assert not harness.compare(control, cell.limits)[0], control


def test_a_block_without_its_mlp_is_caught(narrow, monkeypatch):
    """Every block of the program cut to its residual and depthwise conv: the MLP's part is gone."""
    from celldetection_tpu_torch.models import convnext
    monkeypatch.setattr(convnext.CNBlock, 'forward', lambda self, x: x + self.dwconv(x))
    ok, checks = _run(small_cell())
    assert not ok, checks
