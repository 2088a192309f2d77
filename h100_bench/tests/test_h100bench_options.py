"""A configuration's constructor options and its reference's weight initialiser, on the CPU.

``harness.cell_weights`` gives each accepted cell the weights it had before
the hooks, bit for bit; a configuration's ``backbone_kwargs`` reach the
model's constructor with ``{"module": ...}`` values made partials of the
program's modules, and loading them brings in no JAX; a reference's
``init_weights`` sets its leaves between the default draw and the factors.
"""
import json
import os
import subprocess
import sys
import types

import pytest
import torch

from h100_bench import harness, weights
from h100_bench.tests.conftest import small_cell

CELLS = ['u22_tiles_fp32_b1', 'rx101_tiles_bf16_b4', 'u22_mosaic8k_fp32_b1']
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.parametrize('name', CELLS)
def test_cell_weights_are_the_default_draw(name):
    cell = small_cell(name)
    shapes = cell.ref.shapes(cell.cfg)
    for seed in (7, 2 ** 31 + 11):
        got = harness.cell_weights(cell, seed)
        want = weights.make_weights(shapes, seed, 'cpu', cell.cfg.get('weight_factors', ()))
        assert list(got) == list(want)
        for key in want:
            assert torch.equal(got[key], want[key]), (seed, key)
        del want
    model = harness.build_program(cell, got)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == shapes


def mamba_cell(module='MambaLayer') -> harness.Cell:
    """A CpnResNet18UNet with a Mamba block after each encoder stage, as a configuration's
    file would give it; it has no reference, so the model keeps the constructor's state."""
    cfg = dict(model='CpnResNet18UNet', in_channels=3, order=5, samples=32, max_detections=256,
               refinement_iterations=4, nms_thresh=0.2, refinement_margin=3.0,
               backbone_kwargs={'secondary_block': {'module': module, 'd_state': 8},
                                'pyramid_pooling': False})
    return harness.Cell('mamba_probe', {'config': 'cpn_resnet18_mamba'}, cfg,
                        {'precision': 'fp32'}, {}, None, [], [], torch.device('cpu'))


def build_mamba_program():
    cell = mamba_cell()
    return harness.build_program(cell, harness.build_program(cell).state_dict())


def test_backbone_kwargs_build_mamba_blocks():
    from celldetection_tpu_torch.models import MambaLayer
    resolved = harness.backbone_kwargs(mamba_cell())
    assert resolved['secondary_block'].func is MambaLayer
    assert resolved['secondary_block'].keywords == {'d_state': 8}
    assert resolved['pyramid_pooling'] is False
    body = build_mamba_program().core.backbone.body
    for i in range(1, 5):
        block = getattr(body, f'secondary{i}')
        assert type(block) is MambaLayer
        assert tuple(block.mamba.A_log.shape) == (2 * 64 * 2 ** (i - 1), 8)


def test_backbone_kwargs_build_loads_no_jax():
    code = ('import json; from h100_bench import harness; '
            'from h100_bench.tests.test_h100bench_options import build_mamba_program; '
            'build_mamba_program(); print(json.dumps(harness.forbidden_modules()))')
    env = dict(os.environ)
    env.pop('JAX_PLATFORMS', None)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize('module', ['NoSuchLayer', 'cpn'])
def test_an_unknown_module_is_refused(module):
    with pytest.raises(ValueError, match=f"'cpn_resnet18_mamba'.*'{module}'"):
        harness.build_program(mamba_cell(module))


def test_init_weights_sets_leaves_before_the_factors():
    shapes = {'stem.weight': (4, 3, 3, 3), 'mix.A_log': (6, 4), 'mix.D': (6,),
              'mix.bias': (6,)}
    seen = []

    def init_weights(p, cfg, gen):
        assert cfg is cell.cfg
        seen.append(torch.rand(3, generator=gen))
        p['mix.A_log'].copy_(torch.log(torch.arange(1., 5.)).expand(6, 4))

    ref = types.SimpleNamespace(shapes=lambda cfg: shapes, init_weights=init_weights)
    cell = harness.Cell('stub', {'config': 'stub'}, {'weight_factors': [['A_log$', 2.0]]}, {},
                        {}, ref, [], [], torch.device('cpu'))
    got = harness.cell_weights(cell, 5)
    plain = weights.make_weights(shapes, 5, 'cpu')
    assert torch.equal(got['mix.A_log'], 2.0 * torch.log(torch.arange(1., 5.)).expand(6, 4))
    for key in ('stem.weight', 'mix.D', 'mix.bias'):
        assert torch.equal(got[key], plain[key]), key
    # the initialiser's generator follows the seed, apart from the default draw's
    harness.cell_weights(cell, 5)
    harness.cell_weights(cell, 6)
    assert torch.equal(seen[0], seen[1]) and not torch.equal(seen[0], seen[2])
    default = torch.rand(3, generator=torch.Generator().manual_seed(5))
    assert not torch.equal(seen[0], default)
