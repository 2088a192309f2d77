from .cpn_inference import preprocess

__all__ = ['preprocess']
