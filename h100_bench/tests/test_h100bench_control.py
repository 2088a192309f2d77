"""The check that decides ``correct`` fails where it must, on the CPU at test sizes.

The control (the reference in the next lower precision put in the program's
place: bf16 for an fp32 cell, fp8 for a bf16 one) fails the cell's limits;
a run whose timed path is broken underneath (an answer altered where it is
produced; half of a batch left out) comes out with ``correct`` false; a
sound run comes out true. These drive a whole run of each cell's driver,
without the look for a card, at small sizes; the readings from which the
limits were set come from the same code on the card at the cells' sizes
(``h100_bench/calibrate.py``).
"""
import types

import pytest
import torch

from h100_bench import calibrate, harness
from h100_bench.tests.conftest import small_cell

CELLS = ['u22_tiles_fp32_b1', 'rx101_tiles_bf16_b4', 'u22_mosaic8k_fp32_b1']


def _run(cell, seed=2 ** 31 + 11):
    args = types.SimpleNamespace(seed=seed, seconds=0.5, trace=0)
    res = harness.driver(cell).run(cell, args, 0.)
    return harness.compare(res['numbers'], cell.limits)


@pytest.mark.parametrize('name', CELLS)
def test_control_fails_the_limits(name):
    cell = small_cell(name, precision='fp32')   # the program on the CPU: fp32 alike
    drv = harness.driver(cell)
    state = {}
    sound = calibrate.sound(cell, drv, 5, 0.5, state)
    assert harness.compare(sound, cell.limits)[0], sound
    cell.mix = dict(cell.mix, precision=small_cell(name).mix['precision'])
    control = calibrate.control(cell, drv, 5, state)
    assert not harness.compare(control, cell.limits)[0], control


@pytest.mark.parametrize('name', CELLS)
def test_a_sound_run_is_correct(name):
    cell = small_cell(name, precision='fp32')
    ok, checks = _run(cell)
    assert ok, checks


@pytest.mark.parametrize('name', CELLS)
def test_an_answer_altered_where_it_is_produced_is_caught(name, monkeypatch):
    """One detection's score moved by 0.05 where the decode produces it."""
    from celldetection_tpu_torch.models import cpn as port_cpn
    original = port_cpn.cpn_decode

    def altered(*a, **kw):
        out = original(*a, **kw)
        out['scores'] = out['scores'].clone()
        out['scores'][0, 0] -= 0.05
        return out
    monkeypatch.setattr(port_cpn, 'cpn_decode', altered)
    ok, checks = _run(small_cell(name, precision='fp32'))
    assert not ok, checks


def test_a_kept_box_dropped_in_the_stitch_is_caught(monkeypatch):
    from celldetection_tpu_torch.parallel import tiles as port_tiles
    original = port_tiles.nms_chunked

    def dropped(*a, **kw):
        keep, ovf = original(*a, **kw)
        keep = keep.clone()
        keep[keep.nonzero()[0, 0]] = False
        return keep, ovf
    monkeypatch.setattr(port_tiles, 'nms_chunked', dropped)
    ok, checks = _run(small_cell('u22_mosaic8k_fp32_b1', precision='fp32'))
    assert not ok and checks['output_mismatch']['value'] > 0, checks


def test_half_of_the_batch_left_out_is_caught(monkeypatch):
    """The second half of a batch answered with the first half's results."""
    from celldetection_tpu_torch.models.cpn import CPN
    original = CPN.forward_padded

    def half(self, inputs, **kw):
        n = inputs.shape[0] // 2
        out = original(self, inputs[:n], **kw)
        return {k: (v if not torch.is_tensor(v) or v.dim() == 0 else torch.cat([v, v]))
                if not isinstance(v, tuple) else tuple(torch.cat([x, x]) for x in v)
                for k, v in out.items()}
    monkeypatch.setattr(CPN, 'forward_padded', half)
    ok, checks = _run(small_cell('rx101_tiles_bf16_b4', precision='fp32'))
    assert not ok, checks
