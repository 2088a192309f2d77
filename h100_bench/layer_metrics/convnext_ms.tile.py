"""Device-stream ms of the ConvNeXt encoder a batch: the program spans convnext.stage (CUDA events
around each stage of models/convnext.py: ConvNeXtEncoder.forward inside cpn.core, its stem or
downsample and its blocks), summed a batch and averaged over the traced stretch's batches. Nothing
on a program without the span."""
from h100_bench.program_spans import per_request


def read(run):
    return per_request(run, {'tiles': 'cpn.forward'}, 'convnext.stage', 'stream_ms')
