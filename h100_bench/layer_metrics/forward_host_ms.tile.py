"""Host ms of CPN.forward_padded a batch (the program span cpn.forward): how long the host spends
enqueueing the forward and blocking inside it, mean over the traced stretch's batches."""
from h100_bench.program_spans import per_request


def read(run):
    return per_request(run, {'tiles': 'cpn.forward'}, 'cpn.forward', 'host_ms')
