"""Device-stream ms of the per-image NMS a batch: the program span cpn.nms around batched_box_nms,
mean over the traced stretch's batches."""
from h100_bench.program_spans import per_request


def read(run):
    return per_request(run, {'tiles': 'cpn.forward'}, 'cpn.nms', 'stream_ms')
