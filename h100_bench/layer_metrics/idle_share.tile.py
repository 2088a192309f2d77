"""1 - busy / window of the traced stretch (profiler's device intervals, union), single tiles."""


def read(run):
    tr = run.get('trace') or {}
    if run.get('kind') != 'tiles' or not tr.get('busy_s'):
        return None
    return 100. * (1. - tr['busy_s'] / tr['window_s'])
