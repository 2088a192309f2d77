from . import cpn, fpn, resnet, unet
from .commons import (ConvNorm, Dropout2d, FusableReadOut, Norm, Normalize, ReadOut, ScaledTanh,
                      TwoConvNormRelu, fused_head_conv, get_activation)
from .cpn import *  # noqa: F403  CPN, CPNCore, get_cpn and every Cpn* constructor
from .fpn import FPN, BackboneWithFPN, FeaturePyramidNetwork
from .resnet import ResNetEncoder, get_resnet
from .unet import U12, U22, BackboneAsUNet, GeneralizedUNet, UNet, UNetEncoder

__all__ = ['ConvNorm', 'Dropout2d', 'FusableReadOut', 'Norm', 'Normalize', 'ReadOut', 'ScaledTanh',
           'TwoConvNormRelu', 'fused_head_conv', 'get_activation', 'models_by_name', 'U12',
           'U22', 'BackboneAsUNet', 'GeneralizedUNet', 'UNet', 'UNetEncoder', 'FPN',
           'BackboneWithFPN', 'FeaturePyramidNetwork', 'ResNetEncoder', 'get_resnet',
           *cpn.__all__]
