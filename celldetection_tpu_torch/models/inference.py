"""A callable inference wrapper with optional bf16 compute.

Counterpart of ``celldetection_tpu/models/inference.py: Inference`` (14-39).
"""
import torch

__all__ = ['Inference']


class Inference:
    """Calls ``model`` on inputs, optionally transformed first, in bf16 when
    ``amp``: the model's ``compute_dtype`` is set for the call alone and
    restored afterwards, also when the call raises.

    Examples:
        >>> infer = Inference(model, amp=True)       # bf16 backbone and heads
        >>> detections = infer(images)
    """

    def __init__(self, model, amp: bool = False, transform=None):
        self.model = model
        self.amp = amp
        self.transform = transform

    def __call__(self, inputs, **kwargs):
        if self.transform is not None:
            inputs = self.transform(inputs)
        prev = self.model.compute_dtype
        self.model.compute_dtype = torch.bfloat16 if self.amp else None
        try:
            return self.model(inputs, **kwargs)
        finally:
            self.model.compute_dtype = prev
