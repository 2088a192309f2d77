"""TiledInference.stats forward_ms + retry_ms, mean over the window's mosaics."""


def read(run):
    stats = run.get('stats')
    if run.get('kind') != 'mosaic' or not stats:
        return None
    return sum(s['forward_ms'] + s['retry_ms'] for s in stats) / len(stats)
