"""Peak device memory of the measured window (torch.cuda.max_memory_allocated after
reset_peak_memory_stats), single tiles."""


def read(run):
    if run.get('kind') != 'tiles' or not run.get('peak_bytes'):
        return None
    return run['peak_bytes'] / 2 ** 30
