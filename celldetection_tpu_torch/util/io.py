"""File helpers: HDF5, JSON and YAML, images, TIFF and base64.

Counterpart of ``celldetection_tpu/util/io.py`` (17-148), copied so that the
port imports nothing of the JAX package. Every optional package (h5py,
imageio, tifffile, yaml) is imported inside the function that needs it, and
a missing one raises ``ImportError`` naming it and the function.
"""
import importlib
import json
from typing import Optional

import numpy as np

__all__ = ['to_h5', 'from_h5', 'to_batched_h5', 'to_json', 'from_json', 'to_yaml',
           'from_yaml', 'load_image', 'to_tiff', 'img_to_base64', 'base64_to_img',
           'image_to_base64', 'base64_to_image', 'glob_h5_split']


def _require(module: str, what: str):
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f'{what} needs the package {module.split(".")[0]}, which is not '
                          f'installed') from e


def to_h5(filename, mode: str = 'w', compression=None, attributes: Optional[dict] = None,
          **arrays):
    """Write named arrays to an HDF5 file (None values are left out), and
    optional root attributes."""
    h5py = _require('h5py', 'to_h5')
    with h5py.File(filename, mode) as h:
        for k, v in arrays.items():
            if v is None:
                continue
            if k in h:
                del h[k]
            h.create_dataset(k, data=np.asarray(v), compression=compression)
        if attributes:
            for k, v in attributes.items():
                h.attrs[k] = v


def from_h5(filename, *keys):
    """Read arrays from an HDF5 file (all keys if none are given)."""
    h5py = _require('h5py', 'from_h5')
    with h5py.File(filename, 'r') as h:
        if not keys:
            keys = list(h.keys())
        out = tuple(np.asarray(h[k]) for k in keys)
    return out[0] if len(out) == 1 else out


def to_batched_h5(filename, mode: str = 'a', **ragged):
    """Append ragged per-item arrays as numbered datasets ``<key>/<index>``."""
    h5py = _require('h5py', 'to_batched_h5')
    with h5py.File(filename, mode) as h:
        for key, items in ragged.items():
            grp = h.require_group(key)
            start = len(grp)
            for i, item in enumerate(items):
                grp.create_dataset(str(start + i), data=np.asarray(item))


def img_to_base64(image: np.ndarray, fmt: str = 'png') -> str:
    """Encode an image array as a base64 string of a ``fmt`` file."""
    import base64
    import io as _io
    imwrite = _require('imageio.v2', 'img_to_base64').imwrite
    buf = _io.BytesIO()
    imwrite(buf, image, format=fmt)
    return base64.b64encode(buf.getvalue()).decode()


def base64_to_img(data: str) -> np.ndarray:
    import base64
    import io as _io
    imread = _require('imageio.v2', 'base64_to_img').imread
    return np.asarray(imread(_io.BytesIO(base64.b64decode(data))))


def to_json(filename, obj):
    with open(filename, 'w') as f:
        json.dump(obj, f, indent=2, default=str)


def from_json(filename):
    with open(filename) as f:
        return json.load(f)


def to_yaml(filename, obj):
    yaml = _require('yaml', 'to_yaml')
    with open(filename, 'w') as f:
        yaml.safe_dump(obj, f)


def from_yaml(filename):
    yaml = _require('yaml', 'from_yaml')
    with open(filename) as f:
        return yaml.safe_load(f)


def load_image(filename, method: str = 'imageio', separator: str = '::',
               dataset: Optional[str] = None) -> np.ndarray:
    """Load an image file (tiff, png, jpg, ...) or an HDF5 dataset, named
    ``file.h5<separator>key`` or, for a plain ``.h5`` name, ``dataset``.

    Args:
        method: Reader of plain images, ``'imageio'`` or ``'tifffile'``.
    """
    name = str(filename)
    if '.h5' in name:
        if separator in name:
            fn, key = name.rsplit(separator, 1)
            if fn.endswith('.h5'):
                return from_h5(fn, key)
        if name.endswith('.h5') and dataset is not None:
            return from_h5(name, dataset)
    if method == 'tifffile':
        return np.asarray(_require('tifffile', 'load_image').imread(name))
    return np.asarray(_require('imageio.v2', 'load_image').imread(name))


def to_tiff(filename, image: np.ndarray, bigtiff: bool = True, **kwargs):
    """Write a (large) image as a zlib-compressed BigTIFF with tifffile, or
    with imageio where tifffile is not installed."""
    try:
        import tifffile
    except ImportError:
        _require('imageio.v2', 'to_tiff without tifffile').imwrite(filename, image)
        return
    tifffile.imwrite(filename, image, bigtiff=bigtiff, compression='zlib', **kwargs)


# the reference's spellings
def image_to_base64(image, fmt: str = 'png') -> str:
    return img_to_base64(image, fmt)


def base64_to_image(data: str):
    return base64_to_img(data)


def glob_h5_split(pathname: str, ext: str = '-r.h5', **kwargs):
    """Names of split-HDF5 families without the split suffix, as h5py's family
    driver takes them."""
    import glob as _glob
    pattern = pathname if pathname.endswith(ext) else pathname + ext
    return [f[:-len(ext)] for f in _glob.glob(pattern, **kwargs)]
