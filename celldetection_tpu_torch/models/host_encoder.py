"""timm and smp encoder names: the native encoder where the port has one.

Counterpart of ``celldetection_tpu/models/host_encoder.py:38-107``
(``NATIVE_ENCODER_NAMES``, ``normalize_encoder_name``,
``resolve_native_encoder``, ``build_host_encoder``). The JAX package runs a
timm or smp encoder on the host through a callback; in the port such an
encoder is an ordinary ``nn.Module`` (:mod:`.timmodels`, :mod:`.smp`), and
timm and smp are imported only when a name outside the native table asks
for them.
"""
__all__ = ['NATIVE_ENCODER_NAMES', 'normalize_encoder_name', 'resolve_native_encoder',
           'build_host_encoder', 'resolve_encoder']

# timm / smp encoder names with a native encoder in this package (smp's
# 'timm-' and 'tu-' prefixes are stripped before the lookup)
NATIVE_ENCODER_NAMES = {
    'resnet18': 'ResNet18', 'resnet34': 'ResNet34', 'resnet50': 'ResNet50',
    'resnet101': 'ResNet101', 'resnet152': 'ResNet152',
    'resnext50_32x4d': 'ResNeXt50', 'resnext101_32x8d': 'ResNeXt101',
    'wide_resnet50_2': 'WideResNet50', 'wide_resnet101_2': 'WideResNet101',
    'densenet121': 'DenseNet121', 'densenet161': 'DenseNet161',
    'densenet169': 'DenseNet169', 'densenet201': 'DenseNet201',
    'convnext_tiny': 'ConvNeXtTiny', 'convnext_small': 'ConvNeXtSmall',
    'convnext_base': 'ConvNeXtBase', 'convnext_large': 'ConvNeXtLarge',
    'convnextv2_tiny': 'ConvNeXtV2Tiny', 'convnextv2_base': 'ConvNeXtV2Base',
    'mobilenetv3_large_100': 'MobileNetV3Large',
    'mobilenetv3_small_100': 'MobileNetV3Small',
}


def normalize_encoder_name(model_name: str) -> str:
    """Strip smp's 'timm-'/'tu-' prefixes and lowercase for the table lookup."""
    name = (model_name or '').lower()
    for prefix in ('timm-', 'tu-'):
        if name.startswith(prefix):
            name = name[len(prefix):]
    return name


def resolve_native_encoder(model_name: str, in_channels: int = 3, backbone_kwargs: dict = None):
    """timm/smp encoder name → the port's native encoder module, or None
    where the architecture has none (the caller then builds the timm or smp
    encoder)."""
    native_name = NATIVE_ENCODER_NAMES.get(normalize_encoder_name(model_name))
    if native_name is None:
        return None
    from . import convnext, densenet, mobilenetv3, resnet
    for lib in (resnet, densenet, convnext, mobilenetv3):
        ctor = getattr(lib, native_name, None)
        if ctor is not None:
            bk = dict(backbone_kwargs or {})
            bk.pop('trainable', None)   # native modules are always trainable
            return ctor(in_channels, **bk)
    raise AssertionError(f'the native table names an unknown constructor {native_name!r}')


def build_host_encoder(adapter: str, model_name: str, in_channels: int = 3,
                       pretrained: bool = False, backbone_kwargs: dict = None):
    """A timm (``adapter='timm'``) or smp encoder module; ``backbone_kwargs``'
    ``trainable`` (False by default, as in the JAX package) freezes its
    parameters when off. Raises ``ImportError`` naming the missing package."""
    bk = dict(backbone_kwargs or {})
    trainable = bk.pop('trainable', False)
    if adapter == 'timm':
        from .timmodels import TimmEncoder
        enc = TimmEncoder(model_name, in_channels=in_channels, pretrained=pretrained, **bk)
    elif adapter == 'smp':
        from .smp import SmpEncoder
        enc = SmpEncoder(model_name, in_channels=in_channels,
                         weights='imagenet' if pretrained else None, **bk)
    else:
        raise ValueError(f'Unknown host adapter: {adapter!r}')
    enc.requires_grad_(bool(trainable))
    return enc


def resolve_encoder(adapter: str, model_name: str, in_channels: int = 3, pretrained: bool = False,
                    backbone_kwargs: dict = None):
    """``(encoder, native)``: the port's native encoder of a timm/smp name, else
    timm's or smp's (``backbone_kwargs={'force_host': True}`` skips the native
    one), as the JAX package's CPN and MaNet constructors resolve a name."""
    bk = dict(backbone_kwargs or {})
    if not bk.pop('force_host', False):
        native = resolve_native_encoder(model_name, in_channels, backbone_kwargs=bk)
        if native is not None:
            return native, True
    return build_host_encoder(adapter, model_name, in_channels, pretrained, bk), False
