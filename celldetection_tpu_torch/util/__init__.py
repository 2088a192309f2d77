from .config import Config, Schedule, conf2call, conf2optimizer, conf2scheduler, conf2tweaks_
from .device import resolve_device
from .init import torch_init_
from .logging import MetricsLogger, log_figure
from .misc import *  # noqa: F401,F403
from .pt_pickle import PTUnpickleError, load_pt
from .rois import contour2roi_bytes, load_imagej_rois, roi_bytes2contour, save_rois
from .shm_cache import ShmCache
from .surgery import *  # noqa: F401,F403
from .system import *  # noqa: F401,F403
from .timer import *  # noqa: F401,F403
from .serialization import (fetch_model, hash_file, load_model, load_model_meta,
                            save_fetchable_model, save_model)
from .tiling import Tiling, calculate_padding, ensure_num_tuple, get_tiling_slices
from .weights import init_jax_variables, jax_variables_from_state_dict, state_dict_from_jax
from . import logging, misc, pt_pickle, rois, shm_cache, surgery, system, timer

__all__ = ['Config', 'Schedule', 'conf2tweaks_', 'resolve_device', 'state_dict_from_jax', 'init_jax_variables', 'Tiling',
           'get_tiling_slices', 'ensure_num_tuple', 'calculate_padding', 'conf2call',
           'conf2optimizer', 'conf2scheduler', 'jax_variables_from_state_dict', 'torch_init_',
           'save_model', 'load_model', 'load_model_meta', 'fetch_model', 'save_fetchable_model',
           'hash_file', 'MetricsLogger', 'log_figure', 'ShmCache', 'save_rois',
           'contour2roi_bytes', 'load_imagej_rois', 'roi_bytes2contour', 'load_pt',
           'PTUnpickleError', 'logging', 'misc', 'pt_pickle', 'rois', 'shm_cache', 'surgery',
           'system', 'timer']
__all__ += misc.__all__ + surgery.__all__ + system.__all__ + timer.__all__
