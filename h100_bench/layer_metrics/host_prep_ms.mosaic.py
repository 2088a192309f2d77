"""TiledInference.stats total_ms less its named stages (tiling, input copy and preparation on the
host), mean over the window's mosaics."""


def read(run):
    stats = run.get('stats')
    if run.get('kind') != 'mosaic' or not stats:
        return None
    rest = ('forward_ms', 'retry_ms', 'stitch_ms', 'readback_ms')
    return sum(s['total_ms'] - sum(s[k] for k in rest) for s in stats) / len(stats)
