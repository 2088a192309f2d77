"""Seeding, device memory statistics, OOM retry and size formatting.

Counterpart of ``celldetection_tpu/util/system.py``. The JAX package reads
``device.memory_stats()``; the port reads PyTorch's CUDA allocator
(``torch.cuda.memory_allocated``) and the driver (``torch.cuda.mem_get_info``,
the device's properties). The random states are Python's, numpy's and
torch's (CPU and every CUDA device's), with no JAX key.
"""
import os
import pickle
import random

import numpy as np
import torch

from .device import resolve_device

__all__ = ['random_seed', 'Bytes', 'Percent', 'TpuStats', 'GpuStats', 'OomCatcher',
           'get_total_memory', 'save_random_states', 'load_random_states',
           'num_bytes', 'get_random_states']


def num_bytes(x) -> int:
    """Size in bytes of an ndarray or a tensor."""
    if isinstance(x, torch.Tensor):
        return int(x.numel()) * int(x.element_size())
    shape = np.shape(x)
    itemsize = getattr(getattr(x, 'dtype', None), 'itemsize', None)
    if itemsize is None:
        itemsize = np.asarray(x).dtype.itemsize
    return int(np.prod(shape)) * int(itemsize)


def _cuda_ready() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def get_random_states() -> dict:
    """The current states of Python's, numpy's and torch's generators (the
    CUDA devices' where CUDA is in use)."""
    states = {'random': random.getstate(), 'numpy': np.random.get_state(),
              'torch': torch.get_rng_state()}
    if _cuda_ready():
        states['cuda'] = torch.cuda.get_rng_state_all()
    return states


def random_seed(seed: int, deterministic: bool = True) -> torch.Generator:
    """Seed Python's, numpy's and torch's generators (every device's);
    ``deterministic`` also asks cuDNN for deterministic algorithms. Returns a
    ``torch.Generator`` seeded with ``seed``, for the caller's own draws (the
    JAX package returns a PRNG key)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    return torch.Generator().manual_seed(seed)


class Bytes(int):
    """Integer byte count with a human-readable repr."""

    def __str__(self):
        v = float(self)
        for unit in ('B', 'KiB', 'MiB', 'GiB', 'TiB'):
            if abs(v) < 1024 or unit == 'TiB':
                return f'{v:.2f} {unit}'
            v /= 1024
        return f'{v:.2f} TiB'

    __repr__ = __str__


class Percent(float):
    def __str__(self):
        return f'{float(self) * 100:.1f}%'

    __repr__ = __str__


class GpuStats:
    """Live memory of CUDA devices: per device ``dev{i}_used``, the bytes
    PyTorch's allocator holds in tensors, and ``dev{i}_util``, that over the
    device's total memory (the keys of the JAX package's ``TpuStats``).

    Args:
        devices: Device indices or ``torch.device`` s; all visible CUDA devices by default.
    """

    def __init__(self, devices=None):
        if devices is None:
            devices = range(torch.cuda.device_count())
        self.devices = [torch.device('cuda', d) if isinstance(d, int) else torch.device(d)
                        for d in devices]

    def dict(self) -> dict:
        out = {}
        for i, d in enumerate(self.devices):
            used = torch.cuda.memory_allocated(d)
            _, total = torch.cuda.mem_get_info(d)
            out[f'dev{i}_used'] = Bytes(used)
            if total:
                out[f'dev{i}_util'] = Percent(used / total)
        return out

    def __str__(self):
        return ', '.join(f'{k}={v}' for k, v in self.dict().items())


TpuStats = GpuStats  # the JAX package's name


def get_total_memory(device=None) -> Bytes:
    """Total memory of a device in bytes: a CUDA device's (``cuda`` by
    default), or for ``'cpu'`` the host's physical memory."""
    device = resolve_device(device)
    if device.type == 'cpu':
        return Bytes(os.sysconf('SC_PAGE_SIZE') * os.sysconf('SC_PHYS_PAGES'))
    return Bytes(torch.cuda.get_device_properties(device).total_memory)


class OomCatcher:
    """Retry context for out-of-memory errors with a shrinking size hint.

    Catches ``torch.cuda.OutOfMemoryError`` and any error whose message says
    "out of memory" (or XLA's ``RESOURCE_EXHAUSTED``), frees PyTorch's cached
    blocks, and lets the loop try again with the size times ``factor``.

    Examples:
        >>> catcher = OomCatcher(attempts=3, initial=64)
        >>> for batch_size in catcher:               # doctest: +SKIP
        ...     with catcher:
        ...         run(batch_size)
    """

    def __init__(self, attempts: int = 3, factor: float = 0.5, initial: int = None,
                 verbose: bool = True):
        self.attempts = attempts
        self.factor = factor
        self.initial = initial
        self.verbose = verbose
        self._attempt = 0
        self.ok = False

    def __iter__(self):
        size = self.initial
        while self._attempt < self.attempts and not self.ok:
            yield size
            if size is not None and not self.ok:
                size = max(1, int(size * self.factor))

    def __enter__(self):
        self._attempt += 1
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is None:
            self.ok = True
            return False
        is_oom = isinstance(exc, torch.cuda.OutOfMemoryError) or \
            'RESOURCE_EXHAUSTED' in str(exc) or 'out of memory' in str(exc).lower()
        if is_oom and self._attempt < self.attempts:
            if self.verbose:
                print(f'OomCatcher: OOM on attempt {self._attempt}, retrying.')
            if _cuda_ready():
                torch.cuda.empty_cache()
            return True  # swallow and retry
        return False


def save_random_states(filename: str, generator: torch.Generator = None):
    """Write Python's, numpy's and torch's generator states (and those of
    ``generator``, with its device) to ``filename`` for a reproducible resume."""
    state = get_random_states()
    state['torch'] = state['torch'].numpy()
    if 'cuda' in state:
        state['cuda'] = [s.numpy() for s in state['cuda']]
    if generator is not None:
        state['generator'] = (str(generator.device), generator.get_state().numpy())
    with open(filename, 'wb') as f:
        pickle.dump(state, f)


def load_random_states(filename: str):
    """Restore the states :func:`save_random_states` wrote; returns the saved
    ``torch.Generator`` (None if none was saved)."""
    with open(filename, 'rb') as f:
        state = pickle.load(f)
    random.setstate(state['random'])
    np.random.set_state(state['numpy'])
    torch.set_rng_state(torch.from_numpy(state['torch']))
    if 'cuda' in state and torch.cuda.is_available():
        torch.cuda.set_rng_state_all([torch.from_numpy(s) for s in state['cuda']])
    if 'generator' in state:
        device, gstate = state['generator']
        g = torch.Generator(device=device)
        g.set_state(torch.from_numpy(gstate))
        return g
    return None
