"""Reading PyTorch ``.pt``/``.ckpt`` files into numpy, through a restricted unpickler.

Counterpart of ``celldetection_tpu/util/pt_pickle.py: load_pt``. The
archive's ``data.pkl`` is read by the restricted unpickler of
:mod:`.torch_import` (torch's and Python's rebuild functions, numpy's array
and scalar rebuilds and ``collections`` only), its storages from the
archive's ``data/<key>`` records; here a global outside that list becomes a
placeholder that raises ``PTUnpickleError`` when the pickle calls it, as the
JAX package's reader refuses it. Every tensor of the result is a numpy
array (bfloat16 as ``ml_dtypes.bfloat16`` where that package is installed,
else float32).
"""
import io
import warnings
import zipfile

import numpy as np
import torch

from .torch_import import _allowed, _Unpickler

__all__ = ['load_pt', 'PTUnpickleError']


class PTUnpickleError(RuntimeError):
    pass


class _Refused:
    """A global outside the allow-list: it may be named in the pickle, never called."""

    def __init__(self, module, name):
        self.__module__ = module
        self.__name__ = name

    def __call__(self, *args, **kwargs):
        raise PTUnpickleError(f'checkpoint pickle tried to call {self.__module__}.'
                              f'{self.__name__}; refusing (restricted unpickler)')

    def __repr__(self):
        return f'<pt-placeholder {self.__module__}.{self.__name__}>'


class _Reader(_Unpickler):
    """The restricted unpickler over a checkpoint's ``data.pkl``: storages come
    from the archive's ``data/<key>`` records, globals outside the allow-list
    are refused."""

    def __init__(self, file, archive: zipfile.ZipFile, prefix: str):
        super().__init__(file, encoding='utf-8')
        self._archive, self._prefix, self._storages = archive, prefix, {}

    def find_class(self, module, name):
        if module in ('torch', 'torch.storage') and name.endswith('Storage') and \
                isinstance(getattr(torch, name, None), type):
            return getattr(torch, name)
        if _allowed(module, name):
            return super().find_class(module, name)
        return _Refused(module, name)

    def persistent_load(self, pid):
        # ('storage', storage_type, key, location, numel)
        if not (isinstance(pid, tuple) and len(pid) >= 5 and pid[0] == 'storage'):
            raise PTUnpickleError(f'unsupported persistent id: {pid!r}')
        storage_type, key = pid[1], str(pid[2])
        dtype = torch.uint8 if storage_type is torch.UntypedStorage else storage_type.dtype
        if key not in self._storages:
            raw = bytearray(self._archive.read(f'{self._prefix}data/{key}'))
            untyped = torch.frombuffer(raw, dtype=torch.uint8).untyped_storage() if raw \
                else torch.UntypedStorage(0)
            self._storages[key] = torch.storage.TypedStorage(wrap_storage=untyped, dtype=dtype,
                                                             _internal=True)
        return self._storages[key]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError:
            return t.float().numpy()
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _numpy_tree(obj):
    if isinstance(obj, torch.Tensor):
        return _to_numpy(obj)
    if isinstance(obj, dict):
        return type(obj)((k, _numpy_tree(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_numpy_tree(v) for v in obj)
    return obj


def load_pt(filename: str):
    """The object tree of a zip-format PyTorch checkpoint, every tensor a numpy array.

    Raises:
        PTUnpickleError: the file is not a zip-format checkpoint (the legacy
            format before PyTorch 1.6), or its pickle calls a global outside
            the allow-list.
    """
    if not zipfile.is_zipfile(filename):
        raise PTUnpickleError(f'{filename}: not a zip-format torch checkpoint (legacy pre-1.6 '
                              f'format)')
    with zipfile.ZipFile(filename) as zf:
        pkl = [n for n in zf.namelist() if n.split('/')[-1] == 'data.pkl']
        if not pkl:
            raise PTUnpickleError(f'{filename}: no data.pkl in archive')
        name = min(pkl, key=len)
        with zf.open(name) as f, warnings.catch_warnings():
            warnings.filterwarnings('ignore', 'TypedStorage is deprecated')   # torch's own rebuild
            data = _Reader(io.BytesIO(f.read()), zf, name[:-len('data.pkl')]).load()
    return _numpy_tree(data)
