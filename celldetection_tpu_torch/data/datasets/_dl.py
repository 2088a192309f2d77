"""Dataset download and extraction (atomic, idempotent).

Counterpart of ``celldetection_tpu/data/datasets/_dl.py``.
"""
import os
import zipfile
from urllib.request import urlretrieve

__all__ = ['download_and_extract']


def download_and_extract(url: str, directory: str, extract_to: str = None) -> str:
    """Download ``url`` into ``directory`` once and extract it once.

    The download goes to ``<name>.part`` and is renamed when complete, so an
    interrupted transfer never leaves a truncated file behind; a marker file
    ``<name>.extracted`` keeps a second call from extracting again.
    """
    os.makedirs(directory, exist_ok=True)
    fn = os.path.join(directory, url.rsplit('/', 1)[-1])
    if not os.path.isfile(fn):
        tmp = fn + '.part'
        try:
            urlretrieve(url, tmp)
            os.replace(tmp, fn)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    marker = fn + '.extracted'
    if not os.path.isfile(marker):
        with zipfile.ZipFile(fn) as z:
            z.extractall(extract_to or directory)
        open(marker, 'w').close()
    return fn
