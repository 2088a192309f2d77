"""Reference checkpoints: the cd-format ``.pt`` and Lightning's ``.ckpt``.

Counterpart of ``celldetection_tpu/util/torch_import.py:load_torch_cd_model``
(403-454). The reference's state-dict keys are the port's own, so the
weights load with ``strict=True``; only the ResNet stem's layout is read from
the keys (:func:`.weights.detect_encoder_layout`).

The file is read by ``torch.load`` through a restricted pickle module, as the
JAX package's ``util/pt_pickle.py`` restricts its own reader: only torch's
and Python's own rebuild functions, numpy's array and scalar rebuilds and
``collections`` are looked up. Every other global, such as the reference's
model classes, becomes a placeholder class of the same name, and its module
is never imported.
"""
import pickle
import re
import types

import torch

from .weights import detect_encoder_layout

__all__ = ['load_torch_cd_model', 'restricted_pickle']

_ALLOWED = {
    ('collections', 'OrderedDict'), ('builtins', 'set'), ('builtins', 'frozenset'),
    ('_codecs', 'encode'), ('torch', 'Size'), ('torch.nn.parameter', 'Parameter'),
    ('torch._tensor', '_rebuild_from_type_v2'), ('torch.storage', '_load_from_bytes'),
    # numpy scalars and arrays in stored hyperparameters
    ('numpy', 'dtype'), ('numpy', 'ndarray'),
    ('numpy.core.multiarray', '_reconstruct'), ('numpy.core.multiarray', 'scalar'),
    ('numpy._core.multiarray', '_reconstruct'), ('numpy._core.multiarray', 'scalar'),
}


class _Placeholder:
    """Stands in for a global outside the allow-list: takes any arguments
    and state, and does nothing."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        self.args = args

    def __setstate__(self, state):
        self.state = state


def _allowed(module: str, name: str) -> bool:
    if (module, name) in _ALLOWED:
        return True
    if module == 'torch._utils' and name.startswith('_rebuild_'):
        return True
    return module == 'torch' and isinstance(getattr(torch, name, None), torch.dtype)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if _allowed(module, name):
            return super().find_class(module, name)
        return type(name, (_Placeholder,), {'__module__': module, '__qualname__': name})


restricted_pickle = types.ModuleType('restricted_pickle')
restricted_pickle.Unpickler = _Unpickler
restricted_pickle.__doc__ = 'pickle with the restricted find_class of torch_import'


def _load(f, **kwargs):
    return _Unpickler(f, **kwargs).load()


restricted_pickle.load = _load


def load_torch_cd_model(filename: str, **overrides):
    """Load a reference cd-format ``.pt`` or a Lightning ``.ckpt`` as a port CPN.

    The model is rebuilt from the stored class name and keyword arguments
    (``overrides`` replace them; ``device='cpu'`` places it) and takes the
    stored weights with ``strict=True``: keys without the ``core.`` prefix
    get it, and BatchNorm's ``num_batches_tracked``, which the port does not
    keep, is dropped.
    """
    from .serialization import build_cpn
    data = torch.load(filename, map_location='cpu', weights_only=False,
                      pickle_module=restricted_pickle)
    if 'cd.models' in data:
        info = data['cd.models']
        stored = info['model']
        model_name = overrides.pop('model', None) or (
            stored if isinstance(stored, str) else getattr(stored, '__name__', str(stored)))
        kwargs = dict(info.get('kwargs', {}))
        kwargs.update(info.get('updated_kwargs', {}))
        state_dict = data['state_dict']
    elif 'state_dict' in data:  # Lightning ckpt
        state_dict = {re.sub(r'^model\.', '', k): v for k, v in data['state_dict'].items()}
        hp = data.get('hyper_parameters', {})
        model_name = overrides.pop('model', hp.get('model'))
        kwargs = dict(hp.get('kwargs', {}))
    else:
        raise ValueError(f'Unrecognized checkpoint format: {list(data)[:8]}')
    kwargs.update(overrides)
    sd = {(k if k.startswith('core.') else f'core.{k}'): torch.as_tensor(v)
          for k, v in state_dict.items() if not k.endswith('num_batches_tracked')}
    encoder, fused = detect_encoder_layout(sd)
    if encoder == 'resnet':
        kwargs['backbone_kwargs'] = {**(kwargs.get('backbone_kwargs') or {}),
                                     'fused_initial': fused}
    model = build_cpn(model_name, kwargs, torch_init=False)
    model.load_state_dict(sd, strict=True)
    return model
