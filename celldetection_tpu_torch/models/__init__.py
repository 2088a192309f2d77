from .commons import (ConvNorm, FusableReadOut, Norm, Normalize, ReadOut, ScaledTanh,
                      TwoConvNormRelu, fused_head_conv, get_activation)
from .cpn import CPN, CPNCore, CpnU12, CpnU22, cpn_decode, get_cpn, local_refinement, models_by_name
from .unet import U12, U22, BackboneAsUNet, GeneralizedUNet, UNet, UNetEncoder

__all__ = ['ConvNorm', 'FusableReadOut', 'Norm', 'Normalize', 'ReadOut', 'ScaledTanh',
           'TwoConvNormRelu', 'fused_head_conv', 'get_activation', 'CPN', 'CPNCore', 'CpnU12',
           'CpnU22', 'cpn_decode', 'get_cpn', 'local_refinement', 'models_by_name', 'U12', 'U22',
           'BackboneAsUNet', 'GeneralizedUNet', 'UNet', 'UNetEncoder']
