__title__ = 'celldetection-tpu-torch'
__version__ = '0.1.0'
__summary__ = ('The PyTorch/CUDA port of celldetection-tpu: cell instance segmentation with '
               'Contour Proposal Networks on NVIDIA GPUs')
__license__ = 'Apache-2.0'
