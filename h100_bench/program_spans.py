"""The program's span records of a run, for the per-layer metrics that read them.

The records are ``celldetection_tpu_torch.util.spans.collect()`` of the
run's own process (rank 0's, over several ranks). The program records spans
only while a profiler session is active, which in a run is the traced
stretch (``trace.record``), so the records cover exactly that stretch. A
program without the recorder gives none, and a metric that reads them then
reports nothing.
"""


def records() -> list:
    try:
        from celldetection_tpu_torch.util import spans
    except ImportError:
        return []
    return spans.collect()


def per_request(run: dict, roots: dict, name: str, field: str = 'host_ms', minus: str = None):
    """The mean over the requests (outermost spans named ``roots[kind]`` for
    the run's kind: a batch's forward, a mosaic, or a mosaic over ranks) of
    ``field`` summed over the spans ``name`` inside them; with ``minus``,
    each such span's children of that name are taken out (its self time
    without them). None where the run's kind is not in ``roots`` or the run
    holds no span ``name`` with ``field`` inside a request."""
    root = roots.get(run.get('kind'))
    if root is None:
        return None
    recs = records()
    roots = {r['id'] for r in recs if r['name'] == root and r['parent'] is None}
    sel = [r for r in recs if r['name'] == name and r['request'] in roots
           and r.get(field) is not None]
    if not sel:
        return None
    total = 0.
    for r in sel:
        total += r[field]
        if minus is not None:
            total -= sum(c[field] for c in recs if c['parent'] == r['id'] and c['name'] == minus
                         and c.get(field) is not None)
    return total / len(roots)
