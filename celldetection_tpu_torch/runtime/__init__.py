from .cpn_inference import cpn_inference, infer_input, preprocess, resolve_model, write_outputs
from .trainer import CPNTrainer

__all__ = ['preprocess', 'cpn_inference', 'resolve_model', 'infer_input', 'write_outputs',
           'CPNTrainer']
