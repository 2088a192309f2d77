"""Share of the H100's dense peak over every tile forward of the window's mosaics: the reference's
FLOPs of one tile x tile forwards/s (host clock)."""


def read(run):
    if run.get('kind') != 'mosaic' or 'flops_per_tile' not in run:
        return None
    from h100_bench.roofline import PEAK_FLOPS
    return 100. * run['flops_per_tile'] * run['tile_forwards_per_s'] / PEAK_FLOPS[run['precision']]
