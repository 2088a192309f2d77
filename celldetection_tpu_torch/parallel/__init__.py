from .tiles import (TiledInference, compact_detections, multihost_tiled_inference,
                    stitch_detections, stitch_flat, tile_image, tta_inference)
from .mesh import (all_filter, cpu_count, get_num_nodes, get_rank, host_all_reduce_sum,
                   initialize_distributed, make_mesh, shard_inputs_by_process)
from .train import TrainState, make_train_step, mesh_spans_processes
from .tasks import TaskServer, query, serve, sink
from . import mesh, tasks, tiles, train

__all__ = ['TiledInference', 'tile_image', 'stitch_detections', 'stitch_flat',
           'compact_detections', 'tta_inference', 'multihost_tiled_inference', 'TrainState',
           'make_train_step', 'mesh_spans_processes', 'make_mesh', 'initialize_distributed',
           'get_rank', 'get_num_nodes', 'shard_inputs_by_process', 'host_all_reduce_sum',
           'cpu_count', 'all_filter', 'serve', 'query', 'sink', 'TaskServer']
