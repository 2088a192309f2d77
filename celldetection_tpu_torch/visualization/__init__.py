"""Figures of images, contours, boxes and scores (matplotlib, imported on use).

Counterpart of ``celldetection_tpu/visualization``. matplotlib is imported
only when a plotting function is called, so ``import celldetection_tpu_torch``
works on a host without it (as the card's machine is).
"""
from .cmaps import *
from .images import *
from . import cmaps, images
