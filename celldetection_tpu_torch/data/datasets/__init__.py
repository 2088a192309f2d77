"""Datasets: the synthetic splits, an HDF5 reader and the BBBC loaders (numpy).

Counterpart of ``celldetection_tpu/data/datasets``. h5py and imageio are
imported inside the functions that read files, so the package imports
without them. Nothing is downloaded unless a ``download_*`` function (or
``download=True``) asks for it.
"""
from .bbbc038 import BBBC038Train, download_bbbc038
from .bbbc039 import BBBC039Test, BBBC039Train, BBBC039Val, download_bbbc039
from .bbbc041 import BBBC041Test, BBBC041Train, download_bbbc041
from .generic import GenericH5
from .synth import SynthTest, SynthTrain, SynthVal, download_synth

__all__ = ['GenericH5', 'BBBC039Train', 'BBBC039Val', 'BBBC039Test', 'download_bbbc039',
           'BBBC038Train', 'download_bbbc038', 'BBBC041Train', 'BBBC041Test', 'download_bbbc041',
           'SynthTrain', 'SynthVal', 'SynthTest', 'download_synth']
