"""The ConvNeXt encoder's spans: one ``convnext.stage`` a stage, with its counts.

``models/convnext.py: ConvNeXtEncoder.forward`` opens ``convnext.stage``
around each stage, its stem (stage 0) or downsample and its blocks, counting
``stage``, ``batch``, ``tokens`` (the stage's positions), ``channels``,
``in_channels``, ``blocks`` and ``elem_bytes``; the benchmark's
``convnext_ms.tile`` and ``convnext_roofline.tile`` read them. Here, on the
CPU: inside a CPN's eval step the four spans sit under ``cpn.core`` with the
counts of the stages' own outputs (fp32 and bf16, sides the strides divide
and sides they do not), the encoder alone counts the same with the stem as
its own level and on 3-D volumes, and the spans change no output. The module
imports neither JAX nor the JAX package.
"""
import math

import pytest
import torch

from celldetection_tpu_torch.models import convnext, cpn, unet
from celldetection_tpu_torch.util import spans

pytestmark = pytest.mark.usefixtures('one_torch_thread')

DEPTHS, CHANNELS = (1, 1, 2, 1), (32, 64, 96, 128)


@pytest.fixture(scope='module')
def one_torch_thread():
    """One torch thread, as ``test_torch_port_cpn.py``'s fixture of that name."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cpn(compute_dtype=None):
    """A narrow CPN over CpnConvNeXtLargeUNet's blocks, as the registry builds it."""
    torch.manual_seed(0)
    backbone = unet._backbone_unet(convnext._convnext(DEPTHS, CHANNELS))
    return cpn._make_cpn(backbone, 3, name='CpnConvNeXtLargeUNet', max_detections=32,
                         samples=8, device='cpu', compute_dtype=compute_dtype).eval()


def _recorded(fn, *args, **kwargs):
    spans.reset()
    spans.enable()
    try:
        out = fn(*args, **kwargs)
        return out, spans.collect()
    finally:
        spans.disable()
        spans.reset()


def _want(batch, sides, elem_bytes, in_channels=3):
    """The counts of each stage: its positions are the input's sides over 4, 8, 16, 32, rounded up."""
    return [dict(stage=i, batch=batch, tokens=math.prod(-(-s // 2 ** (i + 2)) for s in sides),
                 channels=c, in_channels=([in_channels] + list(CHANNELS))[i], blocks=d,
                 elem_bytes=elem_bytes)
            for i, (d, c) in enumerate(zip(DEPTHS, CHANNELS))]


# a side the strides do not divide in fp32 only: the CPU has no bf16 bilinear
# resize, which the decoder's output takes back to such a side
@pytest.mark.parametrize('dtype, elem_bytes, side', [(None, 4, 64), (torch.bfloat16, 2, 64),
                                                     (None, 4, 70)],
                         ids=['fp32', 'bf16', 'fp32_ragged'])
def test_each_stage_records_its_counts_inside_core(dtype, elem_bytes, side):
    model = _cpn(dtype)
    x = torch.rand(2, side, side, 3, generator=torch.Generator().manual_seed(side))
    with torch.no_grad():
        _, recs = _recorded(model.forward_padded, x, score_thresh=0.)
    core = [r for r in recs if r['name'] == 'cpn.core']
    stages = [r for r in recs if r['name'] == 'convnext.stage']
    assert len(core) == 1 and len(stages) == 4
    assert all(r['parent'] == core[0]['id'] for r in stages)
    forward = next(r for r in recs if r['name'] == 'cpn.forward')
    assert all(r['request'] == forward['id'] for r in stages)
    assert [r['counts'] for r in stages] == _want(2, (side, side), elem_bytes)


@pytest.mark.parametrize('fused_initial', [True, False])
def test_the_encoder_counts_its_outputs(fused_initial):
    enc = convnext.ConvNeXtEncoder(3, DEPTHS, CHANNELS, fused_initial=fused_initial).eval()
    x = torch.rand(1, 3, 48, 80, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        feats, recs = _recorded(enc, x)
    outs = list(feats.values())[0 if fused_initial else 1:]
    assert [r['counts']['tokens'] for r in recs] == [math.prod(f.shape[2:]) for f in outs]
    assert [r['counts'] for r in recs] == _want(1, (48, 80), 4)
    assert [r['parent'] for r in recs] == [None] * 4


def test_a_volume_counts_its_voxels():
    enc = convnext.ConvNeXtEncoder(2, DEPTHS, CHANNELS, nd=3).eval()
    x = torch.rand(1, 2, 32, 32, 64, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        feats, recs = _recorded(enc, x)
    assert [r['counts'] for r in recs] == _want(1, (32, 32, 64), 4, in_channels=2)
    assert [r['counts']['tokens'] for r in recs] == \
        [math.prod(f.shape[2:]) for f in feats.values()]


@pytest.mark.parametrize('dtype', [None, torch.bfloat16], ids=['fp32', 'bf16'])
def test_the_spans_change_no_output(dtype):
    """Recording or not, the eval step gives the same bits; off, nothing is recorded."""
    model = _cpn(dtype)
    x = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(3))
    spans.reset()
    with torch.no_grad():
        off = model.forward_padded(x, score_thresh=0.)
        assert spans.collect() == []
        on, recs = _recorded(model.forward_padded, x, score_thresh=0.)
    assert sum(r['name'] == 'convnext.stage' for r in recs) == 4
    for k in ('dense_scores', 'boxes', 'scores', 'valid', 'contours'):
        assert torch.equal(off[k], on[k]), k
