"""Whole step's share of the H100's dense peak for the cell's precision: the reference's
convolution and matmul FLOPs of one tile x tiles/s (host clock)."""


def read(run):
    if run.get('kind') != 'tiles' or 'flops_per_tile' not in run:
        return None
    from h100_bench.roofline import PEAK_FLOPS
    return 100. * run['flops_per_tile'] * run['tiles_per_s'] / PEAK_FLOPS[run['precision']]
