"""Timing with device synchronisation.

Counterpart of ``celldetection_tpu/util/timer.py``: named timers, ``timed``,
``Timer`` and ``print_timing``. Where the JAX package blocks on a probe
program, the port calls ``torch.cuda.synchronize()`` (when a card is in use:
CUDA is initialised); ``profiler_trace`` records ``torch.profiler`` and
writes a Chrome trace into ``log_dir``. ``timed`` and ``Timer`` time their
block as a span of :mod:`.spans` under their name, so that it shows in a
profiler trace beside the port's own spans.
"""
import os
import time
from contextlib import contextmanager

import torch

from .spans import span

__all__ = ['start_timer', 'stop_timer', 'timed', 'Timer', 'profiler_trace', 'print_timing']

_TIMERS = {}


def print_timing(name: str, seconds: float):
    """One aligned timing line in s, ms or us, whichever reads at least 1."""
    for unit, scale in (('s', 1.), ('ms', 1e3), ('us', 1e6)):
        if seconds * scale >= 1 or unit == 'us':
            val = round(seconds * scale, 3)
            print(f'{name}:'.ljust(76 - len(str(val))), val, unit)
            return


def _sync():
    """Wait for the work queued on the current CUDA device; nothing on a host
    that has not used a card."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def start_timer(key: str = 'default', cuda: bool = True):
    """Start (or restart) a named timer; synchronises the card first."""
    if cuda:
        _sync()
    _TIMERS[key] = time.perf_counter()


def stop_timer(key: str = 'default', cuda: bool = True, verbose: bool = True) -> float:
    """Stop a named timer and return the seconds since its start."""
    if cuda:
        _sync()
    delta = time.perf_counter() - _TIMERS.pop(key)
    if verbose:
        print(f'{key}: {delta * 1e3:.3f} ms')
    return delta


@contextmanager
def timed(key: str = 'default', verbose: bool = True):
    with Timer(key, verbose=verbose):
        yield


@contextmanager
def profiler_trace(log_dir: str = 'profiles', host_profile: bool = False):
    """Record ``torch.profiler`` (the host, and the card when one is in use)
    over the block; the Chrome trace is written to ``log_dir/trace.json``
    (view it in Perfetto or ``chrome://tracing``)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, 'trace.json')
    prof.export_chrome_trace(path)
    if host_profile:
        print(f'profiler trace written to {path}')


class Timer:
    """Context timer: ``with Timer('fwd') as t: ...; t.seconds``."""

    def __init__(self, name: str = 'timer', sync: bool = True, verbose: bool = False):
        self.name = name
        self.sync = sync
        self.verbose = verbose
        self.seconds = None

    def __enter__(self):
        if self.sync:
            _sync()
        self._span = span(self.name).__enter__()
        return self

    def __exit__(self, *exc):
        if self.sync:
            _sync()
        self._span.__exit__(*exc)
        self.seconds = self._span.ms * 1e-3
        if self.verbose:
            print(f'{self.name}: {self.seconds * 1e3:.3f} ms')
