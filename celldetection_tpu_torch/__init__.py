"""celldetection_tpu_torch — the PyTorch/CUDA port of ``celldetection_tpu``.

The JAX package ``celldetection_tpu`` is the reference; this package mirrors
its module layout (``ops``, ``models``, ``kernels``, ``optim``, ``parallel``, ``callbacks``,
``runtime``, ``data``, ``util``) so each port module sits at the same path as
its counterpart. It imports ``torch``, numpy and scipy only, never ``jax``,
``flax``, ``optax``, ``celldetection_tpu``, ``cv2`` or scikit-image.

Entry points run on ``cuda`` unless the caller passes ``device='cpu'``; with
no card and no explicit CPU request they raise. Public functions keep the
JAX layouts: NHWC images, channels-last dense maps, ``[B, K, S, 2]`` contours.
"""
from . import callbacks, data, kernels, models, ops, optim, parallel, runtime, util  # noqa: F401
from .util.config import (Config, Schedule, conf2call, conf2optimizer, conf2scheduler,  # noqa: F401
                          conf2tweaks_)

__version__ = '0.1.0'
