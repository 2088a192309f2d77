from .cpn_inference import preprocess
from .trainer import CPNTrainer

__all__ = ['preprocess', 'CPNTrainer']
