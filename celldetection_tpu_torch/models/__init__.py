from . import (convnext, cpn, densenet, features, filters, fpn, host_encoder, mamba, manet,
               mobilenetv3, normalization, ppm, resnet, smp, timmodels, unet)
from .commons import (ConvNorm, ConvNormRelu, Dropout2d, FusableReadOut, Fuse, NamedNorm, Norm,
                      Normalize, ReadOut, ResBlock, ScaledTanh, StochasticDepth, TwoConvNormRelu,
                      fused_head_conv, get_activation, set_norm_group_)
from .convnext import ConvNeXt, ConvNeXtEncoder, ConvNeXtV2
from .cpn import *  # noqa: F403  CPN, CPNCore, get_cpn and every Cpn* constructor
from .densenet import DenseNet, DenseNetEncoder
from .features import MultiscaleBasicFeatures, texture_filter
from .filters import (BoxFilter2d, EdgeFilter2d, Filter2d, GaussianFilter2d, LaplaceFilter2d,
                      PascalFilter2d, ScharrFilter2d, SobelFilter2d, UpFilter2d, gaussian_kernel,
                      pascal_kernel)
from .fpn import FPN, BackboneWithFPN, FeaturePyramidNetwork
from .host_encoder import NATIVE_ENCODER_NAMES, resolve_native_encoder
from .inference import Inference
from .mamba import Mamba, MambaLayer, selective_scan
from .manet import MaNet, MaNetDecoder, MultiscaleFusionAttention, PositionWiseAttention
from .mobilenetv3 import MobileNetV3Encoder, MobileNetV3Large, MobileNetV3Small
from .normalization import PixelNorm
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
           'resolve_native_encoder', 'Inference', 'Mamba', 'MambaLayer', 'selective_scan',
           'PixelNorm', 'MultiscaleBasicFeatures', 'texture_filter', 'Filter2d', 'PascalFilter2d',
           'ScharrFilter2d', 'SobelFilter2d', 'GaussianFilter2d', 'BoxFilter2d', 'LaplaceFilter2d',
           'EdgeFilter2d', 'UpFilter2d', 'pascal_kernel', 'gaussian_kernel', *cpn.__all__]
