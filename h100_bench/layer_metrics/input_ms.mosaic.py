"""Host ms a mosaic of model.prepare_inputs and the geometry copies to the device (the program span
tiled.prepare_inputs), mean over the traced stretch's mosaics; over ranks, rank 0's (its share of
the tiles)."""
from h100_bench.program_spans import per_request

ROOTS = {'mosaic': 'tiled.call', 'mosaic_ranks': 'ranks.call'}


def read(run):
    return per_request(run, ROOTS, 'tiled.prepare_inputs')
