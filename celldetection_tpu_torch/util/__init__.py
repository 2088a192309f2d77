from .device import resolve_device
from .weights import init_jax_variables, state_dict_from_jax

__all__ = ['resolve_device', 'state_dict_from_jax', 'init_jax_variables']
