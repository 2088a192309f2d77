from .keepalive import KeepAlive
from .dropout import StepDropout

__all__ = ['KeepAlive', 'StepDropout']
