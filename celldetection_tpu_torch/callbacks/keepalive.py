"""KeepAlive watchdog: kill stalled jobs.

The port's copy of ``celldetection_tpu/callbacks/keepalive.py``. Behavioral
reference: ``celldetection/callbacks/keepalive.py:11-104`` — a
heartbeat thread that, when no progress signal arrives within ``timeout``,
cancels the Slurm job (``scancel``), aborts, and hard-exits. Here the
progress signal is an explicit ``ping()`` (call it per training step).
"""
import os
import signal
import subprocess
import sys
import threading
import time

__all__ = ['KeepAlive']


class KeepAlive:
    """Watchdog thread. Call ``ping()`` on every step; start with ``start()``.

    On timeout: optional Slurm ``scancel``, SIGTERM to own process group, then
    ``os._exit(1)``.
    """

    def __init__(self, timeout: float = 3600., interval: float = 30., scancel: bool = True,
                 verbose: bool = True):
        self.timeout = timeout
        self.interval = interval
        self.scancel = scancel
        self.verbose = verbose
        self._last = time.time()
        self._stop = threading.Event()
        self._thread = None

    def ping(self):
        self._last = time.time()

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def _run(self):
        while not self._stop.wait(self.interval):
            idle = time.time() - self._last
            if idle > self.timeout:
                if self.verbose:
                    print(f'KeepAlive: no heartbeat for {idle:.0f}s (> {self.timeout:.0f}s); '
                          f'terminating.', file=sys.stderr, flush=True)
                job = os.environ.get('SLURM_JOB_ID')
                if self.scancel and job:
                    try:
                        subprocess.run(['scancel', job], timeout=30)
                    except Exception:
                        pass
                try:
                    # terminate the whole process group (data-loader/worker
                    # children included), falling back to just this process
                    try:
                        os.killpg(os.getpgid(0), signal.SIGTERM)
                    except (OSError, PermissionError):
                        os.kill(os.getpid(), signal.SIGTERM)
                    time.sleep(10)
                finally:
                    os._exit(1)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
