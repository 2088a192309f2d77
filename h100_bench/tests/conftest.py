"""Small cells for the CPU: the cells of BENCHMARK.json at test sizes."""
import pytest
import torch

from h100_bench import harness

SMALL = {
    'u22_tiles_fp32_b1': dict(mix=dict(tile=128, pool_side=512, block=256, check_batches=2,
                                       warmup_batches=1)),
    'rx101_tiles_bf16_b4': dict(mix=dict(tile=128, pool_side=512, block=256, check_batches=1,
                                         warmup_batches=1, batch=2)),
    'u22_mosaic8k_fp32_b1': dict(mix=dict(side=512, block=256, tile=128, stride=96, fg_max=200),
                                 cfg=dict(max_detections=256)),
}


def small_cell(name: str, **mix) -> harness.Cell:
    cell = harness.load_cell(name, device='cpu')
    cell.mix = dict(cell.mix, **SMALL[name].get('mix', {}), **mix)
    cell.cfg = dict(cell.cfg, **SMALL[name].get('cfg', {}))
    return cell


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
