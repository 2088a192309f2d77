from . import (convnext, cpn, densenet, fpn, host_encoder, manet, mobilenetv3, ppm, resnet, smp,
               timmodels, unet)
from .commons import (ConvNorm, ConvNormRelu, Dropout2d, FusableReadOut, Fuse, NamedNorm, Norm,
                      Normalize, ReadOut, ResBlock, ScaledTanh, StochasticDepth, TwoConvNormRelu,
                      fused_head_conv, get_activation, set_norm_group_)
from .convnext import ConvNeXt, ConvNeXtEncoder, ConvNeXtV2
from .cpn import *  # noqa: F403  CPN, CPNCore, get_cpn and every Cpn* constructor
from .densenet import DenseNet, DenseNetEncoder
from .fpn import FPN, BackboneWithFPN, FeaturePyramidNetwork
from .host_encoder import NATIVE_ENCODER_NAMES, resolve_native_encoder
from .inference import Inference
from .manet import MaNet, MaNetDecoder, MultiscaleFusionAttention, PositionWiseAttention
from .mobilenetv3 import MobileNetV3Encoder, MobileNetV3Large, MobileNetV3Small
from .ppm import Ppm
from .resnet import ResNetEncoder, get_resnet
from .unet import (U12, U17, U22, BackboneAsUNet, GeneralizedUNet, ResUNet, SlimU22, UNet,
                   UNetEncoder, WideU22)

__all__ = ['ConvNorm', 'ConvNormRelu', 'Dropout2d', 'FusableReadOut', 'Fuse', 'NamedNorm', 'Norm',
           'Normalize', 'ReadOut', 'ResBlock', 'ScaledTanh', 'StochasticDepth', 'TwoConvNormRelu',
           'fused_head_conv', 'get_activation', 'set_norm_group_', 'models_by_name', 'U12', 'U17', 'U22', 'SlimU22',
           'WideU22', 'ResUNet', 'BackboneAsUNet', 'GeneralizedUNet', 'UNet', 'UNetEncoder',
           'FPN', 'BackboneWithFPN', 'FeaturePyramidNetwork', 'ResNetEncoder', 'get_resnet',
           'ConvNeXt', 'ConvNeXtEncoder', 'ConvNeXtV2', 'DenseNet', 'DenseNetEncoder',
           'MobileNetV3Encoder', 'MobileNetV3Large', 'MobileNetV3Small', 'MaNet', 'MaNetDecoder',
           'MultiscaleFusionAttention', 'PositionWiseAttention', 'Ppm', 'NATIVE_ENCODER_NAMES',
           'resolve_native_encoder', 'Inference', *cpn.__all__]
