"""The one seam of the hand-written kernels: build, load, launch and count.

Each source of ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` at first use, into
``celldetection_tpu_torch/_build/`` (listed in ``.gitignore``); the library
name carries a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source or header rebuilds; a build with extra
``-D`` macros (an instrumented variant) is a library of its own.
The sources expose a plain C interface: no PyTorch headers, so a build takes
seconds. Each C entry takes its stream last and returns 0 or a CUDA error,
which ``cdt_cuda_error_string`` names.

:func:`load` builds a source and declares its entries; :func:`launch` calls
one on the current stream and adds 1 to ``LAUNCHES[name]``, the one count of
the kernels' launches, and to the count ``launches`` of the innermost
recording span (:mod:`..util.spans`).
"""
import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass

import torch

from ..util.spans import count

__all__ = ['CSRC', 'BUILD_DIR', 'NVCC_FLAGS', 'KernelLibrary', 'build_library', 'load', 'launch',
           'LAUNCHES']

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')
# launches of each C entry (``'cdt_nms_resolve'``, ``'cdt_head_conv'``, ...)
# since the process started; callers read differences
LAUNCHES = collections.Counter()
# -fmad=false: no mul+add contraction, so the kernels round like the plain
# PyTorch versions they are held against bit for bit.
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-fmad=false', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


@dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: str
    build_seconds: float   # 0.0 when an earlier build was reused
    log: str               # nvcc's output, -Xptxas -v included


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    candidate = os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'nvcc')
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError('nvcc not found: the CUDA kernels are built with the CUDA toolkit')


def build_library(source: str, defines: tuple = (), libraries: tuple = ()) -> KernelLibrary:
    """Compile ``csrc/<source>`` (if not built yet) and load it.

    Args:
        defines: macros to define (``-D``) for this build.
        libraries: libraries to link (``-l``), e.g. ``'cuda'`` (libcuda) for
            ``cuTensorMapEncodeTiled``.
    """
    src = os.path.join(CSRC, source)
    flags = NVCC_FLAGS + tuple(f'-D{d}' for d in defines)
    libs = tuple(f'-l{name}' for name in libraries)
    digest = hashlib.sha1(' '.join(flags + libs).encode())
    # the source and every header of csrc/ it may include
    for path in [src] + sorted(os.path.join(CSRC, h) for h in os.listdir(CSRC) if h.endswith('.cuh')):
        with open(path, 'rb') as f:
            digest.update(f.read())
    digest = digest.hexdigest()[:12]
    stem = os.path.splitext(source)[0]
    out = os.path.join(BUILD_DIR, f'lib{stem}_{digest}.so')
    log_path = out + '.log'
    seconds = 0.0
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f'{out}.{os.getpid()}.tmp'
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *flags, '-o', tmp, src, *libs],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}')
        with open(log_path, 'w') as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, out)   # atomic: a concurrent build never loads a partial file
    with open(log_path) as f:
        log = f.read()
    return KernelLibrary(ctypes.CDLL(out), out, seconds, log)


def load(source: str, functions: dict, defines: tuple = (), libraries: tuple = ()) -> KernelLibrary:
    """:func:`build_library` of ``csrc/<source>``, with each C entry of
    ``functions`` (name: argument types, the stream last) declared to return
    an int, and ``cdt_cuda_error_string``."""
    built = build_library(source, defines, libraries)
    for name, argtypes in functions.items():
        fn = getattr(built.lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    built.lib.cdt_cuda_error_string.argtypes = [ctypes.c_int]
    built.lib.cdt_cuda_error_string.restype = ctypes.c_char_p
    return built


def launch(built: KernelLibrary, name: str, device: torch.device, *args) -> None:
    """Call the C entry ``name`` with ``args`` and the current stream of
    ``device``, and count it; raise where it returns an error."""
    if device.index is not None and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return launch(built, name, device, *args)
    # the raw stream handle: torch.cuda.current_stream builds a Stream object,
    # several microseconds a launch on the main path
    err = getattr(built.lib, name)(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if err:
        raise RuntimeError(f'{name} launch failed: {built.lib.cdt_cuda_error_string(err).decode()}')
    LAUNCHES[name] += 1
    count('launches')
