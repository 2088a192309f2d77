"""Device-stream ms of the CPN heads' first convolutions a batch: the program spans cpn.head_conv
(CUDA events around each head conv0 call inside cpn.core: the fused contour heads' and the
refinement head's), summed a batch and averaged over the traced stretch's batches. Nothing on a
program without the span."""
from h100_bench.program_spans import per_request


def read(run):
    return per_request(run, {'tiles': 'cpn.forward'}, 'cpn.head_conv', 'stream_ms')
