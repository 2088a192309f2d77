from .tiles import (TiledInference, compact_detections, stitch_detections, stitch_flat,
                    tile_image, tta_inference)
from .mesh import get_num_nodes, get_rank, shard_inputs_by_process
from .train import TrainState, make_train_step

__all__ = ['TiledInference', 'tile_image', 'stitch_detections', 'stitch_flat',
           'compact_detections', 'tta_inference', 'TrainState', 'make_train_step', 'get_rank',
           'get_num_nodes', 'shard_inputs_by_process']
