"""The port's models: the JAX package's ``celldetection_tpu.models`` names
(every module's ``__all__``, and its submodules) from the port's modules."""
from . import (commons, convnext, cpn, densenet, features, filters, fpn, host_encoder, inference,
               mamba, manet, mobilenetv3, normalization, ppm, resnet, smp, timmodels, unet)
from .commons import *  # noqa: F401,F403
from .unet import *  # noqa: F401,F403
from .resnet import *  # noqa: F401,F403
from .fpn import *  # noqa: F401,F403
from .convnext import *  # noqa: F401,F403
from .densenet import *  # noqa: F401,F403
from .mobilenetv3 import *  # noqa: F401,F403
from .manet import *  # noqa: F401,F403
from .filters import *  # noqa: F401,F403
from .ppm import *  # noqa: F401,F403
from .features import *  # noqa: F401,F403
from .normalization import *  # noqa: F401,F403
from .cpn import *  # noqa: F401,F403  CPN, CPNCore, get_cpn and every Cpn* constructor
from .host_encoder import NATIVE_ENCODER_NAMES, resolve_native_encoder
from .inference import Inference
from .mamba import Mamba, MambaLayer, selective_scan

__all__ = [*commons.__all__, *unet.__all__, *resnet.__all__, *fpn.__all__, *convnext.__all__,
           *densenet.__all__, *mobilenetv3.__all__, *manet.__all__, *filters.__all__,
           *ppm.__all__, *features.__all__, *normalization.__all__, *cpn.__all__,
           'NATIVE_ENCODER_NAMES', 'resolve_native_encoder', 'Inference', 'Mamba', 'MambaLayer',
           'selective_scan']
