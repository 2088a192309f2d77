"""The ConvNeXt stages' share of their roofline on the traced batches: the stages' least time over
the device-stream ms of the program spans convnext.stage, both summed over every stage of the
traced batches.

A stage's least time is the larger of its FLOPs (:func:`stage_flops`) at the dense peak for its
element size and the bytes of fused blocks (:func:`stage_bytes`) at the HBM's rate
(h100_bench/roofline.py), from each span's own counts. Both count no more than the stage must do,
so the share cannot pass 100%. Nothing on a program without the span, or where the spans have no
device time."""
from h100_bench import roofline
from h100_bench.program_spans import records

PEAK = {2: roofline.PEAK_FLOPS['bf16'], 4: roofline.PEAK_FLOPS['fp32']}


def _stride(stage):
    return 4 if stage == 0 else 2


def stage_flops(stage, batch, tokens, channels, in_channels, blocks, **_):
    """2 x multiply-adds of the stage's convolutions and matmuls: per block and
    position a depthwise 7x7 (``2 * 49 * C``) and the 4x MLP (``16 * C^2``); the
    stem's 4x4 or the downsample's 2x2 convolution from ``in_channels``."""
    c, k = channels, _stride(stage)
    return batch * tokens * (blocks * (2 * 49 * c + 16 * c * c) + 2 * c * in_channels * k * k)


def stage_bytes(stage, batch, tokens, channels, in_channels, blocks, elem_bytes, **_):
    """Bytes of the stage with each block fused: a block reads its input and writes
    its output once (``2 * batch * tokens * C``) and reads its weights once
    (``8 C^2 + 58 C``: the depthwise kernel and bias, the norm, both linears, γ);
    the stem or downsample reads its input (``k^2`` positions of ``in_channels``
    a token) and its weights and writes its output."""
    c, k = channels, _stride(stage)
    block = 2 * batch * tokens * c + 8 * c * c + 58 * c
    entry = batch * tokens * (k * k * in_channels + c) + c * in_channels * k * k + c \
        + 2 * in_channels
    return elem_bytes * (blocks * block + entry)


def least_ms(counts):
    flops_ms = stage_flops(**counts) / PEAK[counts['elem_bytes']] * 1e3
    bytes_ms = stage_bytes(**counts) / roofline.HBM_BYTES_PER_S * 1e3
    return max(flops_ms, bytes_ms)


def read(run):
    if run.get('kind') != 'tiles':
        return None
    recs = records()
    roots = {r['id'] for r in recs if r['name'] == 'cpn.forward' and r['parent'] is None}
    stages = [r for r in recs if r['name'] == 'convnext.stage' and r['request'] in roots
              and r.get('stream_ms') is not None]
    stream_ms = sum(s['stream_ms'] for s in stages)
    if stream_ms <= 0:
        return None
    return 100. * sum(least_ms(s['counts']) for s in stages) / stream_ms
