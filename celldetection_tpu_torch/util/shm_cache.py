"""Shared-memory (/dev/shm) data staging for cluster nodes.

The port's own copy of ``celldetection_tpu/util/shm_cache.py`` (pure
Python): copy or symlink training files into hash-bucketed /dev/shm folders
with threaded setup/teardown and hash verification.
"""
import hashlib
import os
import shutil
import threading
from typing import List, Optional, Sequence

__all__ = ['ShmCache']


class ShmCache:
    """Stage files into node-local shared memory.

    Args:
        root: Cache root (default ``/dev/shm/celldetection_tpu``).
        verify: Verify sha256 after copying.
        symlink_fallback: Symlink instead of copy when shm is full.
    """

    def __init__(self, root: str = '/dev/shm/celldetection_tpu', verify: bool = True,
                 symlink_fallback: bool = True, num_threads: int = 8):
        self.root = root
        self.verify = verify
        self.symlink_fallback = symlink_fallback
        self.num_threads = num_threads
        self._staged: List[str] = []

    def _bucket(self, filename: str) -> str:
        h = hashlib.sha256(os.path.abspath(filename).encode()).hexdigest()[:8]
        return os.path.join(self.root, h)

    @staticmethod
    def _hash_file(fn, chunk=2 ** 20):
        h = hashlib.sha256()
        with open(fn, 'rb') as f:
            while True:
                b = f.read(chunk)
                if not b:
                    break
                h.update(b)
        return h.hexdigest()

    def _stage_one(self, src: str) -> str:
        bucket = self._bucket(src)
        os.makedirs(bucket, exist_ok=True)
        dst = os.path.join(bucket, os.path.basename(src))
        if os.path.exists(dst):
            return dst
        if not os.path.exists(src):
            raise FileNotFoundError(src)
        try:
            shutil.copy2(src, dst)
        except OSError:
            # copy failure (shm full, permissions): fall back to a symlink
            if not self.symlink_fallback:
                raise
            if os.path.exists(dst):
                os.remove(dst)
            os.symlink(os.path.abspath(src), dst)
        else:
            # hash verification failures must propagate — never fall back
            if self.verify and self._hash_file(src) != self._hash_file(dst):
                os.remove(dst)
                raise IOError(f'Hash mismatch after staging {src}')
        self._staged.append(dst)
        return dst

    def setup(self, files: Sequence[str]) -> List[str]:
        """Stage files (threaded); returns the staged paths in input order."""
        results: List[Optional[str]] = [None] * len(files)
        errors: List[BaseException] = []
        lock = threading.Lock()
        idx = {'i': 0}

        def worker():
            while True:
                with lock:
                    i = idx['i']
                    if i >= len(files):
                        return
                    idx['i'] += 1
                try:
                    results[i] = self._stage_one(files[i])
                except BaseException as e:  # surfaced to the caller below
                    with lock:
                        errors.append(e)
                    return

        threads = [threading.Thread(target=worker) for _ in range(min(self.num_threads, len(files)))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return results  # type: ignore[return-value]

    def teardown(self):
        """Remove everything this cache staged."""
        for fn in self._staged:
            try:
                os.remove(fn)
            except OSError:
                pass
        self._staged.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.teardown()
