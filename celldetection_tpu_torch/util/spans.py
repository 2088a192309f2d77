"""Spans and counters on the profiler's clock: the port's one timing recorder.

``with span(name, **counts) as s: ...`` times a block on the host; ``s.ms``
holds its milliseconds after the block, always (two ``perf_counter_ns``
reads). ``count(key, n)`` adds ``n`` to a count of the innermost recording
span.

A span records only while a ``torch.profiler`` session is active or after
:func:`enable`. Off (the default) it costs one flag check and the two clock
reads. Recording, it also

* enters ``torch.profiler.record_function(name)``, so that the span is a
  ``user_annotation`` in the profiler's trace, on the kernels' clock;
* records a CUDA event pair on the current stream when a card is in use;
  the time between them is the span's ``stream_ms``;
* appends a record: ``name``, ``id``, ``parent`` (the id of the span it is
  nested in, or None), ``request`` (the id of the outermost span it is
  nested in: one ``CPN.forward_padded`` call, or one mosaic), ``t0_ns`` and
  ``t1_ns`` (Unix time in ns, the clock of the profiler's trace),
  ``host_ms``, ``stream_ms`` and ``counts``.

:func:`collect` waits for the card and returns the records (it does not
clear them); :func:`reset` clears them. The spans of the port's layers and
the per-layer metrics that read them are listed in PERF.md §3.

``with host_syncs(device): ...`` counts, while a span records and ``device``
is a card, the synchronising CUDA calls made in the block (those that
``torch.cuda.set_sync_debug_mode('warn')`` reports) as ``host_syncs`` of the
innermost recording span.
"""
import contextlib
import itertools
import threading
import time
import warnings

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ['span', 'count', 'host_syncs', 'enable', 'disable', 'recording', 'collect',
           'reset']

_ON = False
_RECORDS = []
_EVENTS = []           # (record, start, end): CUDA events not read yet
_IDS = itertools.count(1)
_LOCAL = threading.local()


def enable():
    """Record every span from now on, with or without a profiler session."""
    global _ON
    _ON = True


def disable():
    """Record only inside a profiler session again (the default)."""
    global _ON
    _ON = False


def recording() -> bool:
    """Whether a span opened now would record."""
    return _ON or _autograd_profiler._is_profiler_enabled


def _stack() -> list:
    stack = getattr(_LOCAL, 'stack', None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class span:
    """A timed block; see the module's docstring."""
    __slots__ = ('name', 'counts', 'ms', 'id', '_t0', '_unix0', '_rec', '_rf', '_ev')

    def __init__(self, name: str, **counts):
        self.name, self.counts, self.ms, self.id, self._rec = name, counts, None, None, None

    def __enter__(self):
        if _ON or _autograd_profiler._is_profiler_enabled:
            self._open()
        else:
            self._rec = None
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._close()
        else:
            self.ms = (time.perf_counter_ns() - self._t0) * 1e-6
        return False

    def _open(self):
        stack = _stack()
        parent = stack[-1]._rec if stack else None
        self.id = next(_IDS)
        self._rec = dict(name=self.name, id=self.id,
                         parent=None if parent is None else parent['id'],
                         request=self.id if parent is None else parent['request'])
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._ev = None
        if torch.cuda.is_initialized():
            self._ev = torch.cuda.Event(enable_timing=True)
            self._ev.record()
        stack.append(self)
        self._unix0 = time.time_ns()
        self._t0 = time.perf_counter_ns()

    def _close(self):
        # the annotation ends as record_function's exit returns, and the
        # record with it
        rec = self._rec
        if self._ev is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            _EVENTS.append((rec, self._ev, end))
            self._ev = None
        self._rf.__exit__(None, None, None)
        t1 = time.perf_counter_ns()
        self.ms = (t1 - self._t0) * 1e-6
        rec.update(t0_ns=self._unix0, t1_ns=self._unix0 + (t1 - self._t0), host_ms=self.ms,
                   stream_ms=None, counts=self.counts)
        _stack().pop()
        _RECORDS.append(rec)


def count(key: str, n=1):
    """Add ``n`` to count ``key`` of the innermost recording span (nothing when none records)."""
    stack = getattr(_LOCAL, 'stack', None)
    if stack:
        counts = stack[-1].counts
        counts[key] = counts.get(key, 0) + n


_SYNC = 'called a synchronizing CUDA operation'


@contextlib.contextmanager
def host_syncs(device: torch.device):
    """Count ``host_syncs`` (see the module's docstring); nothing where no span
    records, ``device`` is not a card, or the caller has set a sync debug mode
    of its own (its warnings or errors then reach it)."""
    if not (recording() and device.type == 'cuda') or torch.cuda.get_sync_debug_mode():
        yield
        return
    with warnings.catch_warnings(record=True) as caught:
        warnings.filterwarnings('always', message='.*' + _SYNC)
        # torch's notice, once a process, that the mode is a prototype
        warnings.filterwarnings('ignore', message='Synchronization debug mode')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = 0
    for w in caught:
        if _SYNC in str(w.message):
            syncs += 1
        else:
            warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
    count('host_syncs', syncs)


def collect() -> list:
    """Every record so far, in the order the spans closed, each ``stream_ms``
    read (waiting for the card where needed); the records stay."""
    pending = list(_EVENTS)
    del _EVENTS[:len(pending)]
    for rec, start, end in pending:
        end.synchronize()
        rec['stream_ms'] = start.elapsed_time(end)
    return list(_RECORDS)


def reset():
    """Drop every record."""
    _RECORDS.clear()
    _EVENTS.clear()
