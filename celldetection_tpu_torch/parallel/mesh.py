"""Process rank and input sharding for batch inference.

Counterpart of ``celldetection_tpu/parallel/mesh.py``: ``get_rank`` and
``get_num_nodes`` (66-78), ``_node_topology`` (89-101) and
``shard_inputs_by_process`` (104-121). The rank and the number of
processes come from ``torch.distributed`` when it is initialised, and are 0
and 1 otherwise.
"""
import os
from typing import Sequence

import torch.distributed as dist

__all__ = ['get_rank', 'get_num_nodes', 'shard_inputs_by_process']


def get_rank() -> int:
    """This process's rank: ``torch.distributed``'s, else 0."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def get_num_nodes() -> int:
    """The number of processes: ``torch.distributed``'s world size, else 1."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _node_topology():
    """``(node index, number of nodes)``: the scheduler's (``SLURM_NODEID``,
    ``SLURM_NNODES``) where set, else one node per process."""
    nid, nn = os.environ.get('SLURM_NODEID'), os.environ.get('SLURM_NNODES')
    if nid is not None and nn is not None:
        return int(nid), int(nn)
    return get_rank(), get_num_nodes()


def shard_inputs_by_process(inputs: Sequence, group_level: str = 'rank') -> list:
    """The inputs of this process, round robin.

    ``'rank'``: ``inputs[i]`` goes to process ``i % num_processes``;
    ``'node'``: to node ``i % num_nodes``, so that the processes of a node
    share its inputs; ``'job'``: every input to every process.
    """
    if group_level == 'job':
        return list(inputs)
    if group_level == 'rank':
        rank, n = get_rank(), get_num_nodes()
        return [x for i, x in enumerate(inputs) if i % n == rank]
    if group_level == 'node':
        node, n_nodes = _node_topology()
        return [x for i, x in enumerate(inputs) if i % max(n_nodes, 1) == node]
    raise ValueError(f'Unknown group_level: {group_level}')
