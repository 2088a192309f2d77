"""The Mamba scans' share of their roofline on the traced batches: the least time of a fused scan
over the device-stream ms of the program spans mamba.scan (CUDA events around each call of
models/mamba.py: selective_scan), both summed over every scan of the traced batches.

A fused scan reads u, Δ, B, C, A and D once and writes y once; its state stays on chip. Its least
time is those bytes at the HBM's rate (h100_bench/roofline.py), :func:`scan_bytes`, from each
span's own counts. Nothing on a program without the span, or where the spans have no device time."""
from h100_bench import roofline
from h100_bench.program_spans import records


def scan_bytes(batch, tokens, d_inner, d_state, elem_bytes, **_):
    """Bytes a fused scan moves: u, Δ and y ``[batch, tokens, d_inner]``, B and C
    ``[batch, tokens, d_state]``, A ``[d_inner, d_state]`` and D ``[d_inner]``."""
    return elem_bytes * (3 * batch * tokens * d_inner + 2 * batch * tokens * d_state
                         + d_inner * d_state + d_inner)


def read(run):
    if run.get('kind') != 'tiles':
        return None
    recs = records()
    roots = {r['id'] for r in recs if r['name'] == 'cpn.forward' and r['parent'] is None}
    scans = [r for r in recs if r['name'] == 'mamba.scan' and r['request'] in roots
             and r.get('stream_ms') is not None]
    stream_ms = sum(s['stream_ms'] for s in scans)
    if stream_ms <= 0:
        return None
    bound_ms = sum(scan_bytes(**s['counts']) for s in scans) / roofline.HBM_BYTES_PER_S * 1e3
    return 100. * bound_ms / stream_ms
