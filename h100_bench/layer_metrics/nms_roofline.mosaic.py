"""The stitch's NMS entry (nms_chunked) on the checked mosaic's swept rows: least time over CUDA-
event time per call."""


def read(run):
    nms = run.get('nms')
    if run.get('kind') != 'mosaic' or not nms or not nms['device_ms'] > 0:
        return None
    return 100. * nms['bound_ms'] / nms['device_ms']
