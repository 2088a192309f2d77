"""Device-stream ms of the decode a batch (selection, Fourier decode, refinement): the program span
cpn.decode around cpn_decode, mean over the traced stretch's batches."""
from h100_bench.program_spans import per_request


def read(run):
    return per_request(run, {'tiles': 'cpn.forward'}, 'cpn.decode', 'stream_ms')
