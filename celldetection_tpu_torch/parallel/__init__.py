from .tiles import (TiledInference, compact_detections, stitch_detections, stitch_flat,
                    tile_image, tta_inference)
from .train import TrainState, make_train_step

__all__ = ['TiledInference', 'tile_image', 'stitch_detections', 'stitch_flat',
           'compact_detections', 'tta_inference', 'TrainState', 'make_train_step']
