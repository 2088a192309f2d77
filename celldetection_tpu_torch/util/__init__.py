from .config import conf2call, conf2optimizer, conf2scheduler
from .device import resolve_device
from .tiling import Tiling, calculate_padding, ensure_num_tuple, get_tiling_slices
from .weights import init_jax_variables, state_dict_from_jax

__all__ = ['resolve_device', 'state_dict_from_jax', 'init_jax_variables', 'Tiling',
           'get_tiling_slices', 'ensure_num_tuple', 'calculate_padding', 'conf2call',
           'conf2optimizer', 'conf2scheduler']
