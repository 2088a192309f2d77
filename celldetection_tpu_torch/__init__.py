"""celldetection_tpu_torch — the PyTorch/CUDA port of ``celldetection_tpu``.

The JAX package ``celldetection_tpu`` is the reference; this package mirrors
its module layout (``ops``, ``models``, ``kernels``, ``optim``, ``parallel``, ``callbacks``,
``runtime``, ``data``, ``util``) so each port module sits at the same path as
its counterpart. It imports ``torch``, numpy and scipy only, never ``jax``,
``flax``, ``optax``, ``celldetection_tpu``, ``cv2`` or scikit-image;
matplotlib (``visualization``) and tensorboard (``util.MetricsLogger``) are
imported only by the functions that draw or log with them.

Entry points run on ``cuda`` unless the caller passes ``device='cpu'``; with
no card and no explicit CPU request they raise. Public functions keep the
JAX layouts: NHWC images, channels-last dense maps, ``[B, K, S, 2]`` contours.
"""
from .__meta__ import __version__  # noqa: F401
from . import (callbacks, data, kernels, models, native, ops, optim, parallel,  # noqa: F401
               runtime, util, visualization)
from .util.config import (Config, Schedule, conf2call, conf2optimizer, conf2scheduler,  # noqa: F401
                          conf2tweaks_)
from .util.tiling import Tiling, get_tiling_slices  # noqa: F401
from .data.cpn import CPNTargetGenerator  # noqa: F401
from .data.instance_eval import LabelMatcher, LabelMatcherList  # noqa: F401
from .parallel.tiles import TiledInference  # noqa: F401
from .runtime.trainer import CPNTrainer  # noqa: F401
from .runtime.cpn_inference import cpn_inference  # noqa: F401
from .util.serialization import fetch_model, load_model, save_model  # noqa: F401
