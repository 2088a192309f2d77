"""Device-stream ms of the Mamba token mixers a batch: the program spans mamba.layer (CUDA events
around each MambaLayer.forward inside cpn.core, one a ResNet stage), summed a batch and averaged
over the traced stretch's batches. Nothing on a program without the span."""
from h100_bench.program_spans import per_request


def read(run):
    return per_request(run, {'tiles': 'cpn.forward'}, 'mamba.layer', 'stream_ms')
