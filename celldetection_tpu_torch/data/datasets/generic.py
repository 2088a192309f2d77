"""HDF5-backed dataset. Counterpart of ``celldetection_tpu/data/datasets/generic.py``."""
import numpy as np

__all__ = ['GenericH5']


class GenericH5:
    """Dataset over one or more keys of an HDF5 file (h5py, imported on use).

    Args:
        filename: Path to the .h5 file.
        keys: Key or tuple of keys read per item.
        transform: Optional callable applied to the tuple of values.
    """

    def __init__(self, filename: str, keys, transform=None):
        import h5py
        self.filename = filename
        self.keys = (keys,) if isinstance(keys, str) else tuple(keys)
        self.transform = transform
        with h5py.File(filename, 'r') as h:
            self._len = len(h[self.keys[0]])

    def __len__(self):
        return self._len

    def __getitem__(self, item):
        import h5py
        with h5py.File(self.filename, 'r') as h:
            values = tuple(np.asarray(h[k][item]) for k in self.keys)
        if self.transform is not None:
            values = self.transform(*values)
        return values
