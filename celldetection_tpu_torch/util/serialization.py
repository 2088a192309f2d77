"""Model files: the cdt format, hashed file names and hosted-model fetch.

Counterpart of ``celldetection_tpu/util/serialization.py``. A cdt file is one
msgpack map ``{'cdt.models': JSON of {'model': name, 'kwargs': hparams},
'params_bytes': flax bytes of the JAX variables, 'cdt.__version__': ...,
'meta': JSON}``. The port writes ``params_bytes`` as flax's encoding of the
JAX-layout tree (:func:`.weights.jax_variables_from_state_dict`), so files
cross in both directions: one the JAX package's ``save_model`` wrote loads
here, and one written here loads in the JAX package's ``load_model``. The
msgpack is the port's own (:mod:`._msgpack`): neither msgpack nor flax is
needed. ``.pt`` and ``.ckpt`` files go to :func:`.torch_import.load_torch_cd_model`.
"""
import hashlib
import inspect
import json
import os
from typing import Optional

import numpy as np

from ._msgpack import msgpack_restore, msgpack_serialize, packb, unpackb
from .weights import body_layout, jax_variables_from_state_dict, state_dict_from_jax

__all__ = ['model2dict', 'dict2model', 'save_model', 'load_model', 'load_model_meta',
           'fetch_model', 'save_fetchable_model', 'append_hash_to_filename', 'hash_file',
           'hosted_models']

# the hosted model table (celldetection/models/hosted.py); downloads need a
# network, so offline a local path is passed instead
hosted_models = {
    'ginoro_CpnResNeXt101UNet-fbe875f1b3e5ce2c': (
        'https://celldetection.org/torch/models/ginoro_CpnResNeXt101UNet-fbe875f1b3e5ce2c.pt'),
}

# run-time settings that a file records at their current values
_RUNTIME_ATTRS = ('score_thresh', 'nms_thresh', 'samples', 'order', 'max_detections',
                  'refinement_iterations')


def model2dict(model) -> dict:
    """CPN → ``{'cdt.models', 'params_bytes', 'cdt.__version__'}``.

    The run-time settings (thresholds, samples, capacity) are recorded at
    their current values, as the reference's ``updated_kwargs`` does.
    """
    from .. import __version__
    hparams = dict(model.hparams)
    for attr in _RUNTIME_ATTRS:
        hparams[attr] = getattr(model, attr)
    encoder, fused = body_layout(model)
    variables = jax_variables_from_state_dict(model.state_dict(), fused, encoder)
    return {'cdt.models': {'model': hparams.get('model'), 'kwargs': hparams},
            'params_bytes': msgpack_serialize(variables),
            'cdt.__version__': __version__}


def build_cpn(name, kwargs: dict, **defaults):
    """``get_cpn(name)(in_channels, backbone_kwargs=..., **kwargs)`` from
    stored hyperparameters (a copy of ``kwargs`` is used). Options of the
    JAX package that the port does not have are left out when off (None or
    False) and raise otherwise. ``defaults`` fill keys ``kwargs`` lacks."""
    from ..models import get_cpn
    from ..models.cpn import CPN, _make_cpn
    kwargs = {**defaults, **kwargs}
    if not isinstance(name, str):
        name = getattr(name, '__name__', str(name))
    in_channels = kwargs.pop('in_channels')
    backbone_kwargs = kwargs.pop('backbone_kwargs', None)
    ctor = get_cpn(name)
    known = set()
    for fn in (ctor, _make_cpn, CPN.__init__):
        known |= {p.name for p in inspect.signature(fn).parameters.values()
                  if p.kind not in (p.VAR_KEYWORD, p.VAR_POSITIONAL)}
    known -= {'self', 'backbone', 'backbone_fn'}
    accepted = {}
    for k, v in kwargs.items():
        if k in known:
            accepted[k] = v
        elif v is not None and v is not False:
            raise NotImplementedError(f'{name}: the option {k}={v!r} is not ported yet')
    return ctor(in_channels, backbone_kwargs=backbone_kwargs, **accepted)


def dict2model(d: dict, **overrides):
    """Rebuild a model from a cdt-format dict; ``overrides`` replace stored
    hyperparameters (``device='cpu'`` places it)."""
    info = d['cdt.models']
    kwargs = dict(info['kwargs'])
    override_name = overrides.pop('model', None)
    stored_name = kwargs.pop('model', None)
    name = override_name or stored_name or info.get('model')
    kwargs.update(overrides)
    has_weights = 'params_bytes' in d
    # the stored weights replace every parameter, so the init is skipped
    model = build_cpn(name, kwargs, torch_init=not has_weights)
    if has_weights:
        _, fused = body_layout(model)
        sd = state_dict_from_jax(msgpack_restore(d['params_bytes']), fused)
        model.load_state_dict(sd, strict=True)
    return model


def _json_safe(o):
    """JSON fallback: numpy scalars become numbers (a blanket str() would
    reload e.g. score_thresh as the string "0.86")."""
    if isinstance(o, (np.floating, np.integer, np.bool_)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


def save_model(filename: str, model, meta: Optional[dict] = None):
    """Save a model in the cdt format (one msgpack map in one file)."""
    d = model2dict(model)
    payload = {
        'cdt.models': json.dumps(d['cdt.models'], default=_json_safe),
        'params_bytes': d['params_bytes'],
        'cdt.__version__': d['cdt.__version__'],
        'meta': json.dumps(meta or {}, default=_json_safe),
    }
    with open(filename, 'wb') as f:
        f.write(packb(payload))
    return filename


def _read_payload(filename: str) -> dict:
    with open(filename, 'rb') as f:
        return unpackb(f.read())


def load_model_meta(filename: str) -> dict:
    """The metadata ``save_model`` wrote (with the saving package's version
    under ``'cdt.__version__'``), without building the model."""
    payload = _read_payload(filename)
    meta = json.loads(payload.get('meta') or '{}')
    meta.setdefault('cdt.__version__', payload.get('cdt.__version__'))
    return meta


def load_model(filename: str, **overrides):
    """Load a cdt model file, or a reference ``.pt``/``.ckpt`` checkpoint."""
    if filename.endswith('.pt') or filename.endswith('.ckpt'):
        from .torch_import import load_torch_cd_model
        return load_torch_cd_model(filename, **overrides)
    payload = _read_payload(filename)
    d = {'cdt.models': json.loads(payload['cdt.models']),
         'params_bytes': payload['params_bytes']}
    return dict2model(d, **overrides)


def hash_file(filename: str, algorithm: str = 'sha256', chunk: int = 2 ** 20) -> str:
    h = hashlib.new(algorithm)
    with open(filename, 'rb') as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def append_hash_to_filename(filename: str, digits: int = 16) -> str:
    """Rename ``name.ext`` → ``name-<hash16>.ext`` (fetchable-model convention)."""
    h = hash_file(filename)[:digits]
    base, ext = os.path.splitext(filename)
    new = f'{base}-{h}{ext}'
    os.replace(filename, new)
    return new


def save_fetchable_model(filename: str, model, **kwargs):
    """Save and hash-stamp a model for hosting."""
    save_model(filename, model, **kwargs)
    return append_hash_to_filename(filename)


def fetch_model(name: str, cache_dir: Optional[str] = None, check_hash: bool = True,
                **overrides):
    """Fetch a hosted model by name or URL (``cd://name`` also accepted).

    A local file path loads as :func:`load_model`. A download needs a
    network; it lands in ``<name>.part`` and is renamed when complete, and a
    file whose name carries a hash that its bytes do not match is removed
    before the call raises.
    """
    if os.path.isfile(name):
        return load_model(name, **overrides)
    if name.startswith('cd://'):
        name = name[5:]
    url = hosted_models.get(name, name)
    if not (url.startswith('http://') or url.startswith('https://')):
        raise ValueError(f'Unknown hosted model and not a URL/path: {name}')
    cache_dir = cache_dir or os.path.join(os.path.expanduser('~'), '.cache',
                                          'celldetection_tpu_torch')
    os.makedirs(cache_dir, exist_ok=True)
    fn = os.path.join(cache_dir, url.rsplit('/', 1)[-1])
    if not os.path.isfile(fn):
        from urllib.request import urlretrieve
        tmp = fn + '.part'
        try:
            urlretrieve(url, tmp)
            os.replace(tmp, fn)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    if check_hash and '-' in os.path.basename(fn):
        expected = os.path.splitext(os.path.basename(fn))[0].rsplit('-', 1)[-1]
        actual = hash_file(fn)[:len(expected)]
        if expected != actual and len(expected) >= 8:
            os.remove(fn)  # force a clean re-fetch next time
            raise RuntimeError(f'Hash mismatch for {fn} (corrupt download '
                               f'removed): {actual} != {expected}')
    return load_model(fn, **overrides)
