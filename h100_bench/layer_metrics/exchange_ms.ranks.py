"""Rank 0's host ms a mosaic in the exchanges between ranks: every program span ranks.exchange (the
kept rows and the restored rows, waits for the slowest rank included), mean over the traced
mosaics."""
from h100_bench.program_spans import per_request


def read(run):
    return per_request(run, {'mosaic_ranks': 'ranks.call'}, 'ranks.exchange')
