"""1 - busy / window of one traced mosaic (profiler's device intervals, union)."""


def read(run):
    tr = run.get('trace') or {}
    if run.get('kind') != 'mosaic' or not tr.get('busy_s'):
        return None
    return 100. * (1. - tr['busy_s'] / tr['window_s'])
