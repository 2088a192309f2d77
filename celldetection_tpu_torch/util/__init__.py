from .config import Config, Schedule, conf2call, conf2optimizer, conf2scheduler, conf2tweaks_
from .device import resolve_device
from .init import torch_init_
from .serialization import (fetch_model, hash_file, load_model, load_model_meta,
                            save_fetchable_model, save_model)
from .tiling import Tiling, calculate_padding, ensure_num_tuple, get_tiling_slices
from .weights import init_jax_variables, jax_variables_from_state_dict, state_dict_from_jax

__all__ = ['Config', 'Schedule', 'conf2tweaks_', 'resolve_device', 'state_dict_from_jax', 'init_jax_variables', 'Tiling',
           'get_tiling_slices', 'ensure_num_tuple', 'calculate_padding', 'conf2call',
           'conf2optimizer', 'conf2scheduler', 'jax_variables_from_state_dict', 'torch_init_',
           'save_model', 'load_model', 'load_model_meta', 'fetch_model', 'save_fetchable_model',
           'hash_file']
