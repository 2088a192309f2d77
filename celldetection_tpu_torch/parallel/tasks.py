"""Task-farm patterns: server / worker / sink.

The port's copy of ``celldetection_tpu/parallel/tasks.py`` (the whole file;
it imports no JAX). Behavioral reference: ``celldetection/mpi/mpi.py:110-359``,
the generic MPI ``serve``/``query``/``sink`` task farm with host discovery.
Here the same API runs over TCP sockets, across hosts without MPI: beside
``torch.distributed`` and input sharding, the farm suits uneven host work
such as overlay rendering.

Examples:
    Server process::

        serve(tasks=iter(range(100)), port=5555)

    Worker process::

        for task in query('server-host', port=5555):
            result = work(task)
            sink('server-host', result, port=5556)
"""
import pickle
import socket
import struct
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

__all__ = ['serve', 'query', 'sink', 'collect', 'TaskServer']

_STOP = b'__task_farm_stop__'


def _send_msg(conn: socket.socket, obj: Any):
    data = pickle.dumps(obj)
    conn.sendall(struct.pack('!Q', len(data)) + data)


def _recv_msg(conn: socket.socket):
    hdr = b''
    while len(hdr) < 8:
        chunk = conn.recv(8 - len(hdr))
        if not chunk:
            raise ConnectionError('connection closed')
        hdr += chunk
    (length,) = struct.unpack('!Q', hdr)
    data = b''
    while len(data) < length:
        chunk = conn.recv(min(length - len(data), 1 << 20))
        if not chunk:
            raise ConnectionError('connection closed')
        data += chunk
    return pickle.loads(data)


class TaskServer:
    """Serves tasks to workers and optionally collects results.

    Args:
        tasks: Iterable of picklable tasks.
        port: Task port; results arrive on ``port + 1`` when ``collect``.
    """

    def __init__(self, tasks: Iterable, port: int = 5555, host: str = '0.0.0.0',
                 collect_results: bool = True):
        self.tasks = iter(tasks)
        self.port = port
        self.host = host
        self.collect_results = collect_results
        self.results = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = []

    def _serve_tasks(self):
        srv = socket.create_server((self.host, self.port))
        srv.settimeout(0.5)
        while not self._stop.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            with conn:
                try:
                    # accepted sockets don't inherit the listener timeout; a
                    # stalled worker must not block the whole farm
                    conn.settimeout(30.0)
                    _recv_msg(conn)  # task request
                    with self._lock:
                        try:
                            task = next(self.tasks)
                        except StopIteration:
                            task = _STOP
                    _send_msg(conn, task)
                except (ConnectionError, socket.timeout, OSError, EOFError,
                        pickle.UnpicklingError):
                    pass  # drop the connection, keep serving
        srv.close()

    def _collect(self):
        srv = socket.create_server((self.host, self.port + 1))
        srv.settimeout(0.5)
        while not self._stop.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            with conn:
                try:
                    conn.settimeout(30.0)
                    self.results.append(_recv_msg(conn))
                except (ConnectionError, socket.timeout, OSError, EOFError,
                        pickle.UnpicklingError):
                    pass
        srv.close()

    def start(self):
        self._threads = [threading.Thread(target=self._serve_tasks, daemon=True)]
        if self.collect_results:
            self._threads.append(threading.Thread(target=self._collect, daemon=True))
        for t in self._threads:
            t.start()
        return self

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def serve(tasks: Iterable, port: int = 5555, **kwargs) -> TaskServer:
    """Start a task server (non-blocking); returns the server object."""
    return TaskServer(tasks, port=port, **kwargs).start()


def query(host: str, port: int = 5555) -> Iterator[Any]:
    """Worker generator: yields tasks from a server until it runs dry."""
    while True:
        with socket.create_connection((host, port), timeout=30) as conn:
            _send_msg(conn, 'task?')
            task = _recv_msg(conn)
        if isinstance(task, bytes) and task == _STOP:
            return
        yield task


def sink(host: str, result: Any, port: int = 5556):
    """Send a result to the server's collector port."""
    with socket.create_connection((host, port), timeout=30) as conn:
        _send_msg(conn, result)


def collect(server: TaskServer) -> list:
    """The results collected so far."""
    return list(server.results)
