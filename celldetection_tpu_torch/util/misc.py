"""Small infrastructure helpers.

The port's own copy of ``celldetection_tpu/util/misc.py`` (pure Python):
``copy_script``, ``random_code_name``, ``grouped_glob``, ``import_file``,
``parse_url_params``, the installed-package helpers, ``Dict`` and the dict
helpers; ``num_params`` counts the elements of a module or a state dict.
"""
import glob as glob_mod
import importlib.util
import os
import random
import shutil
import sys
from typing import List
from urllib.parse import parse_qs, urlparse

__all__ = ['copy_script', 'random_code_name', 'grouped_glob', 'import_file',
           'parse_url_params', 'get_installed_packages', 'say_goodbye',
           'Dict', 'update_dict_', 'dict_hash', 'dict_to_json_string', 'has_argument',
           'is_picklable', 'load_txt', 'print_to_file', 'fetch_image', 'num_params',
           'random_code_name_dir', 'is_ipython', 'is_package_installed',
           'is_from_installed_package', 'save_requirements', 'compare_file_hashes']

_CONSONANTS = 'bcdfghjklmnprstvwz'
_VOWELS = 'aeiou'


def copy_script(dst_dir: str, script: str = None) -> str:
    """Copy the running script into ``dst_dir`` (experiment provenance)."""
    script = script or os.path.abspath(sys.argv[0])
    os.makedirs(dst_dir, exist_ok=True)
    dst = os.path.join(dst_dir, os.path.basename(script))
    shutil.copy2(script, dst)
    return dst


def random_code_name(length: int = 6, rng=None) -> str:
    """Pronounceable random code name (e.g. 'betoka')."""
    rng = rng or random
    out = []
    for i in range(length):
        out.append(rng.choice(_CONSONANTS if i % 2 == 0 else _VOWELS))
    return ''.join(out)


def grouped_glob(*patterns: str) -> List[List[str]]:
    """Glob several patterns, returning aligned (sorted) groups."""
    groups = [sorted(glob_mod.glob(p)) for p in patterns]
    lens = {len(g) for g in groups}
    if len(lens) > 1:
        raise ValueError(f'Glob groups differ in length: {[len(g) for g in groups]}')
    return groups


def import_file(path: str, name: str = None):
    """Import a python file as a module."""
    name = name or os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parse_url_params(url: str) -> dict:
    """URL → (flat) query-parameter dict."""
    q = parse_qs(urlparse(url).query)
    return {k: (v[0] if len(v) == 1 else v) for k, v in q.items()}


def get_installed_packages() -> dict:
    """Installed package versions (for experiment records)."""
    from importlib.metadata import distributions
    return {d.metadata['Name']: d.version for d in distributions()
            if d.metadata and 'Name' in d.metadata}


def say_goodbye() -> str:
    farewells = ('Goodbye', 'So long', 'Farewell', 'Bye', 'Take care',
                 'See you', 'Cheerio', 'Auf Wiedersehen')
    return f'{random.choice(farewells)}!'


class Dict(dict):
    """dict with attribute access (parity: ``cd.Dict``, ``util/util.py:81``)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        del self[name]


def update_dict_(dst: dict, src: dict, override: bool = False, keys=None) -> dict:
    """Merge ``src`` into ``dst`` in place; existing keys survive unless
    ``override`` (parity: ``update_dict_``, ``util/util.py``)."""
    for k, v in src.items():
        if keys is not None and k not in keys:
            continue
        if override or k not in dst:
            dst[k] = v
    return dst


def dict_hash(d: dict) -> str:
    """Deterministic MD5 of a (json-serializable) dict."""
    import hashlib
    import json
    return hashlib.md5(json.dumps(d, sort_keys=True).encode()).hexdigest()


def dict_to_json_string(d: dict) -> str:
    """JSON string of the json-serializable subset of ``d`` (non-serializable
    values are silently dropped — parity: ``dict_to_json_string``)."""
    import json
    keep = {}
    for k, v in d.items():
        try:
            json.dumps(v)
        except TypeError:
            continue
        keep[k] = v
    return json.dumps(keep)


def has_argument(fn, *names, mode: str = 'any') -> bool:
    """Whether ``fn``'s signature declares any/all of ``names``."""
    from inspect import signature
    present = [n in signature(fn).parameters for n in names]
    if mode == 'any':
        return any(present)
    if mode == 'all':
        return all(present)
    raise ValueError(f'Unknown mode: {mode}')


def is_picklable(obj) -> bool:
    import pickle
    try:
        pickle.dumps(obj)
    except Exception:
        return False
    return True


def load_txt(filename: str, strip: bool = True) -> List[str]:
    with open(filename) as f:
        return [ln.strip() for ln in f] if strip else f.readlines()


def print_to_file(*args, filename: str, mode: str = 'w', **kwargs):
    with open(filename, mode) as f:
        print(*args, file=f, **kwargs)


def fetch_image(url: str, numpy: bool = True):
    """An image from a URL (``urlopen``, so it needs a network), as a numpy
    array or a PIL image."""
    from urllib.request import urlopen
    import io
    from PIL import Image
    img = Image.open(io.BytesIO(urlopen(url).read()))
    if numpy:
        import numpy as np
        return np.asarray(img)
    return img


def num_params(variables, trainable: bool = None) -> int:
    """The number of elements of a module's parameters and buffers (its state
    dict), or of a state dict's tensors; ``trainable=True``: of a module's
    parameters alone (the JAX package's ``params`` collection)."""
    import torch
    if isinstance(variables, torch.nn.Module):
        tensors = (variables.parameters() if trainable
                   else variables.state_dict().values())
    else:
        tensors = variables.values()
    return int(sum(t.numel() for t in tensors))


def is_ipython() -> bool:
    """Whether running inside an IPython/Jupyter shell."""
    try:
        from IPython import get_ipython
    except ImportError:
        return False
    return get_ipython() is not None


def is_package_installed(name: str) -> bool:
    import importlib.util
    return importlib.util.find_spec(name) is not None


def is_from_installed_package(obj) -> bool:
    """Whether ``obj``'s defining module lives under site-packages."""
    import inspect
    try:
        path = inspect.getfile(type(obj) if not inspect.isclass(obj)
                               and not inspect.isfunction(obj) else obj)
    except TypeError:
        return False
    return 'site-packages' in path or 'dist-packages' in path


def save_requirements(filename: str = 'requirements.txt'):
    """Write the current environment's package versions (experiment record)."""
    pkgs = get_installed_packages()
    with open(filename, 'w') as f:
        f.writelines(f'{k}=={v}\n' for k, v in sorted(pkgs.items()))
    return filename


def compare_file_hashes(*filenames, hash_name: str = 'md5') -> bool:
    """Whether all files share the same content hash."""
    import hashlib
    digests = set()
    for fn in filenames:
        h = hashlib.new(hash_name)
        with open(fn, 'rb') as f:
            for chunk in iter(lambda: f.read(1 << 20), b''):
                h.update(chunk)
        digests.add(h.hexdigest())
    return len(digests) <= 1


def random_code_name_dir(directory: str = './out', length: int = 6) -> str:
    """Create (and return) a fresh ``directory/<code-name>`` run directory."""
    for _ in range(1000):
        path = os.path.join(directory, random_code_name(length))
        if not os.path.exists(path):
            os.makedirs(path)
            return path
    raise RuntimeError('Could not find a free code name')
