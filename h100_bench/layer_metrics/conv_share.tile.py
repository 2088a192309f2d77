"""Share of the device's busy time in convolution kernels, from the profiler's trace of the traced
stretch."""


def read(run):
    tr = run.get('trace') or {}
    if run.get('kind') != 'tiles' or not tr.get('busy_s'):
        return None
    return 100. * tr['conv_s'] / tr['busy_s']
