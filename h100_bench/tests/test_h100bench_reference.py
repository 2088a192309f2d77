"""The plain reference against the program (celldetection_tpu_torch), on the CPU, at small sizes.

The reference (``h100_bench/reference/``) imports nothing of the program;
these tests may. Same seeded weights (``h100_bench/weights.py``) on both
sides, float32 on the CPU, so the two agree to rounding.
"""
import numpy as np
import pytest
import torch

from h100_bench import harness, judge
from h100_bench.reference import cpn, stitch
from h100_bench.tests.conftest import small_cell

CELLS = ['u22_tiles_fp32_b1', 'rx101_tiles_bf16_b4']


def _program(cell, seed=3, precision='fp32'):
    cell.mix = dict(cell.mix, precision=precision)
    w = harness.cell_weights(cell, seed)
    return harness.build_program(cell, w), w


@pytest.mark.parametrize('name', CELLS)
@pytest.mark.parametrize('side', [64, 128])
def test_dense_maps_match_program(name, side):
    cell = small_cell(name)
    model, w = _program(cell)
    x = torch.rand(1, side, side, 3, generator=torch.Generator().manual_seed(side))
    with torch.no_grad():
        got = model.core(x)
        ref = cpn.dense_forward(cell.ref, w, x, cell.cfg, cpn.Precision('fp32'))
    for key in ('scores', 'locations', 'fourier', 'refinement'):
        assert got[key].shape == ref[key].shape
        err = float((got[key] - ref[key]).abs().max() / ref[key].abs().max())
        assert err < 1e-5, (key, err)


def test_shapes_are_the_programs_state():
    for name in CELLS:
        cell = small_cell(name)
        model, _ = _program(cell)
        state = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert state == cell.ref.shapes(cell.cfg)


@pytest.mark.parametrize('thresh', [0.0, 0.6])
def test_decode_and_nms_match_program(thresh):
    """Both decodes of the very same dense maps (the program's), so rounding of
    the convolutions cannot reorder the selection."""
    from celldetection_tpu_torch.models.cpn import cpn_decode
    from celldetection_tpu_torch.ops.boxes import nms_padded
    cell = small_cell('u22_tiles_fp32_b1')
    model, _ = _program(cell, seed=5)
    cfg = cell.cfg
    x = torch.rand(2, 128, 128, 3, generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        dense = model.core(x)
        prog = cpn_decode(dense, (128, 128), order=cfg['order'], samples=cfg['samples'],
                          score_channels=1, score_thresh=thresh,
                          max_detections=cfg['max_detections'],
                          refinement_iterations=cfg['refinement_iterations'], refinement_buckets=1)
        keep = nms_padded(prog['boxes'], prog['scores'], prog['valid'], cfg['nms_thresh'])
        ref = cpn.decode(dense, (128, 128), cfg, thresh, cfg['max_detections'])
    assert torch.equal(prog['fg_index'], ref['fg_index'])
    assert torch.equal(prog['valid'], ref['valid'])
    for key in ('scores', 'locations', 'contour_proposals'):
        assert float((prog[key] - ref[key]).abs().max()) < 1e-3, key
    # the refinement rounds to pixels: a proposal within rounding of a half pixel
    # may step to the next pixel on one side alone, so most points agree, not all
    close = ((prog['contours'] - ref['contours']).abs() < 1e-3).float().mean()
    assert float(close) > 0.99
    want = torch.stack([cpn.greedy_nms(prog['boxes'][i], prog['scores'][i], prog['valid'][i],
                                       cfg['nms_thresh']) for i in range(2)])
    assert torch.equal(keep, want)


def test_judge_of_program_is_small():
    cell = small_cell('u22_tiles_fp32_b1')
    model, w = _program(cell, seed=6)
    x = torch.rand(1, 128, 128, 3, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        prog = judge.kept_outputs(model.forward_padded(x, score_thresh=0., nms=True))
        ref = cpn.dense_forward(cell.ref, w, x, cell.cfg, cpn.Precision('fp32'))
    got = judge.judge_tiles(prog, ref, cell.cfg, cell.cfg['nms_thresh'])
    assert got['nms_mismatch'] == 0 and got['box_mismatch'] == 0
    assert got['dense_gap'] < 1e-4 and got['refine_gap'] < 1e-4


def test_tiling_matches_program():
    from celldetection_tpu_torch.parallel.tiles import tile_image
    for side, tile, stride in ((512, 128, 96), (8192, 1024, 768), (300, 128, 100)):
        img = np.zeros((side, side, 1), np.uint8)
        _, offs, borders, _, _ = tile_image(img, tile, stride)
        got_offs, got_borders = stitch.tiling(side, side, tile, stride)
        assert np.array_equal(offs, got_offs) and np.array_equal(borders, got_borders)
    assert len(stitch.tiling(8192, 8192, 1024, 768)[0]) == 121


def test_plain_stitch_matches_program():
    from celldetection_tpu_torch.parallel.tiles import TiledInference
    cell = small_cell('u22_mosaic8k_fp32_b1')
    model, w = _program(cell, seed=8)
    g = torch.Generator().manual_seed(2)
    img = (torch.rand(384, 384, 3, generator=g) * 255).to(torch.uint8)
    thresh = 0.5
    mix = dict(cell.mix, tile=128, stride=96)
    with torch.no_grad():
        got = TiledInference(model, tile_size=128, stride=96, max_outputs=100_000)(
            img.numpy(), score_thresh=thresh)
        calls = stitch.window_calls(cell.ref, w, img, cell.cfg, cpn.Precision('fp32'), thresh, mix)
        offs, borders = stitch.tiling(384, 384, 128, 96)
        per, order = stitch.windows_of_calls(calls, len(offs), 1, cell.cfg['max_detections'], 8)
        want = stitch.stitch(per, order, offs, borders, cell.cfg, mix)[2]
    assert len(got['scores']) == len(want['scores']) > 0
    assert np.abs(got['boxes'] - want['boxes']).max() < 1e-2
    assert np.abs(got['scores'] - want['scores']).max() < 1e-5


def test_greedy_nms_matches_program():
    from celldetection_tpu_torch.ops.boxes import nms_padded
    g = torch.Generator().manual_seed(0)
    c = torch.rand(3000, 2, generator=g) * 300
    s = torch.rand(3000, 2, generator=g) * 30 + 2
    boxes = torch.cat([c, c + s], 1)
    scores = torch.rand(3000, generator=g)
    valid = torch.rand(3000, generator=g) > 0.1
    want = nms_padded(boxes, scores, valid, 0.2)
    for block in (64, 2048):
        assert torch.equal(cpn.greedy_nms(boxes, scores, valid, 0.2, block=block), want)
