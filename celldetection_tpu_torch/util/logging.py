"""Metrics and figure logging.

Counterpart of ``celldetection_tpu/util/logging.py``: ``MetricsLogger``
writes one JSON line a call (``step``, ``time`` and the metrics as floats) to
``<log_dir>/<name>.jsonl``, and mirrors the metrics to TensorBoard when
``tensorboard=True`` (its ``SummaryWriter`` is imported only then).
``log_figure`` writes a matplotlib figure to TensorBoard or as a PNG.
"""
import json
import os
import time

__all__ = ['MetricsLogger', 'log_figure']


class MetricsLogger:
    """JSON-lines metrics logger with optional TensorBoard mirroring."""

    def __init__(self, log_dir: str = 'logs', name: str = 'metrics', tensorboard: bool = False):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f'{name}.jsonl')
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir)
            except ImportError:
                pass

    def log(self, step: int, **metrics):
        record = {'step': int(step), 'time': time.time()}
        record.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, 'a') as f:
            f.write(json.dumps(record) + '\n')
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), step)

    def close(self):
        if self._tb is not None:
            self._tb.close()


def log_figure(logger, tag: str, figure, step: int = 0, close: bool = True):
    """Log a matplotlib figure: as an image to a TensorBoard writer (one with
    ``add_image``), else as ``<tag>_<step>.png`` beside the logger's file
    (``logs/`` when it has none)."""
    from ..visualization.images import figure2img, save_fig
    if hasattr(logger, 'add_image'):
        img = figure2img(figure)
        logger.add_image(tag, img, step, dataformats='HWC')
        if close:
            import matplotlib.pyplot as plt
            plt.close(figure)
    else:
        target = getattr(logger, 'path', None)
        out_dir = (os.path.dirname(target) or '.') if isinstance(target, str) else 'logs'
        os.makedirs(out_dir, exist_ok=True)
        save_fig(os.path.join(out_dir, f'{tag.replace("/", "_")}_{step}.png'), figure,
                 close=close)
