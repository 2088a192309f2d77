"""Rank 0's host ms a mosaic in the final NMS rounds over the ranks' rows: the self time of the
program span ranks.final_rounds, its ranks.exchange children taken out; mean over the traced
mosaics."""
from h100_bench.program_spans import per_request


def read(run):
    return per_request(run, {'mosaic_ranks': 'ranks.call'}, 'ranks.final_rounds',
                       minus='ranks.exchange')
