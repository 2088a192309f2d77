"""Build a CUDA source of ``csrc/`` into a shared library and load it with ctypes.

Each source is compiled by ``nvcc`` for ``sm_90a`` at first use, into
``celldetection_tpu_torch/_build/`` (listed in ``.gitignore``); the library
name carries a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source or header rebuilds; a build with extra
``-D`` macros (an instrumented variant) is a library of its own.
The sources expose a plain C interface: no PyTorch headers, so a build takes
seconds.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass

__all__ = ['CSRC', 'BUILD_DIR', 'NVCC_FLAGS', 'KernelLibrary', 'build_library']

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')
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
