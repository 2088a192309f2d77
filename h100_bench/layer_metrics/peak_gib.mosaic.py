"""Peak device memory of the measured window, mosaics."""


def read(run):
    if run.get('kind') != 'mosaic' or not run.get('peak_bytes'):
        return None
    return run['peak_bytes'] / 2 ** 30
