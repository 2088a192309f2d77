"""Step-scheduled dropout (early/late dropout).

The port's copy of ``celldetection_tpu/callbacks/dropout.py``. Behavioral
reference: ``celldetection/callbacks/dropout.py:8-83``, which switches the
model's dropout rates on and off at configured steps. The schedule returns
the rate for a step; the caller sets it on the model's dropout modules (the
``p`` of :class:`..models.commons.Dropout2d`).
"""
__all__ = ['StepDropout']


class StepDropout:
    """Piecewise-constant dropout schedule.

    Args:
        rates: List of (start_step, rate) pairs, sorted by start_step.

    Examples:
        >>> sd = StepDropout([(0, 0.1), (1000, 0.0)])   # disable after 1k steps
        >>> sd(500), sd(2000)
        (0.1, 0.0)
    """

    def __init__(self, rates):
        self.rates = sorted(rates)

    def __call__(self, step: int) -> float:
        current = self.rates[0][1]
        for start, rate in self.rates:
            if step >= start:
                current = rate
        return current
