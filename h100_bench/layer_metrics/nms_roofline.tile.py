"""The NMS entry's share of its roofline on a checked batch: the algorithm's least time
(h100_bench/roofline.py) over CUDA-event time per call of ops/boxes.py: nms_padded."""


def read(run):
    nms = run.get('nms')
    if run.get('kind') != 'tiles' or not nms or not nms['device_ms'] > 0:
        return None
    return 100. * nms['bound_ms'] / nms['device_ms']
