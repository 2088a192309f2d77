"""Device-stream ms of the backbone and heads a batch: the program span cpn.core (CUDA events around
self.core in CPN.forward_padded), mean over the traced stretch's batches."""
from h100_bench.program_spans import per_request


def read(run):
    return per_request(run, {'tiles': 'cpn.forward'}, 'cpn.core', 'stream_ms')
