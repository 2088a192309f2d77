"""Host ms a mosaic of the tiling and mask crops in TiledInference.candidates (the program span
tiled.tile_image), mean over the traced stretch's mosaics; over ranks, rank 0's (every rank tiles
the whole mosaic and keeps its share)."""
from h100_bench.program_spans import per_request

ROOTS = {'mosaic': 'tiled.call', 'mosaic_ranks': 'ranks.call'}


def read(run):
    return per_request(run, ROOTS, 'tiled.tile_image')
