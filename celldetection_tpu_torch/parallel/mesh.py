"""Process groups, the data mesh and multi-process helpers.

Counterpart of ``celldetection_tpu/parallel/mesh.py``: ``initialize_distributed``
(22-39), ``make_mesh`` (42-56), ``get_rank`` and ``get_num_nodes`` (66-78),
``cpu_count`` (81-86), ``_node_topology`` (89-101),
``shard_inputs_by_process`` (104-121), ``all_filter`` (124-138) and
``host_all_reduce_sum`` (141-150).

The port runs one process per card over ``torch.distributed``: the process
group takes the place of the JAX mesh's ``'data'`` axis, and a rank's card is
``cuda:{LOCAL_RANK}`` unless the caller names another device. CUDA ranks talk
over ``nccl``, CPU ranks over ``gloo``; ``backend=`` overrides either and
nothing falls back from one to the other. The JAX package's ``data_sharding``
and ``replicated`` have no counterpart: with one card per rank a batch is
split by giving each rank its own slice, and replicated state is each rank's
copy, kept equal by the collectives.

Host arrays (counts, flags, item records) go through a ``gloo`` group, since
``nccl`` reduces no CPU tensor: the default group where it is ``gloo``, else
one made once with ``dist.new_group(backend='gloo')``.
"""
import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ['initialize_distributed', 'make_mesh', 'mesh_group', 'default_backend', 'host_group',
           'local_rank', 'get_rank', 'get_num_nodes', 'cpu_count', 'shard_inputs_by_process',
           'all_filter', 'host_all_reduce_sum', 'broadcast_from_rank0']

_HOST_GROUP = {}


def _env_int(*names, default=None):
    for name in names:
        if os.environ.get(name) not in (None, ''):
            return int(os.environ[name])
    return default


def local_rank() -> int:
    """This process's index on its node: ``SLURM_LOCALID``, torchrun's
    ``LOCAL_RANK``, else 0."""
    return _env_int('SLURM_LOCALID', 'LOCAL_RANK', default=0)


def default_backend(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` otherwise."""
    return 'nccl' if torch.device(device).type == 'cuda' else 'gloo'


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, backend: Optional[str] = None,
                           device=None, timeout: Optional[float] = None) -> bool:
    """Join the ranks of a multi-process job (a no-op for one process).

    As in the JAX package, an argument wins; where it is None the
    scheduler's variables (``SLURM_NTASKS`` / ``SLURM_PROCID``) are read,
    then torchrun's (``WORLD_SIZE`` / ``RANK``), else one process of rank 0.

    Args:
        coordinator_address: ``host:port`` of rank 0's store; torchrun's
            ``MASTER_ADDR:MASTER_PORT`` when None.
        backend: ``nccl``/``gloo``; by default :func:`default_backend` of
            ``device``.
        device: This rank's device; ``cuda:{LOCAL_RANK}`` by default (raises
            without a card). A CUDA device is made the current one.
        timeout: Seconds a collective may wait before it raises.

    Returns:
        True when a process group of more than one process was initialised.
    """
    from ..util.device import resolve_device
    if num_processes is None:
        num_processes = _env_int('SLURM_NTASKS', 'WORLD_SIZE', default=1)
    if num_processes <= 1:
        return False
    if process_id is None:
        process_id = _env_int('SLURM_PROCID', 'RANK', default=0)
    dev = resolve_device(f'cuda:{local_rank()}' if device is None else device)
    if coordinator_address is None:
        addr, port = os.environ.get('MASTER_ADDR'), os.environ.get('MASTER_PORT')
        if not addr or not port:
            raise ValueError('initialize_distributed: no coordinator_address and no '
                             'MASTER_ADDR/MASTER_PORT in the environment')
        coordinator_address = f'{addr}:{port}'
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    kw = {} if timeout is None else dict(timeout=datetime.timedelta(seconds=timeout))
    dist.init_process_group(backend or default_backend(dev),
                            init_method=f'tcp://{coordinator_address}',
                            world_size=num_processes, rank=process_id, **kw)
    return True


def make_mesh(shape: Optional[Sequence[int]] = None, axis_names: Sequence[str] = ('data',),
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` with one ``'data'`` dimension over every rank.

    ``device_type`` is the ranks' device type, ``'cuda'`` under ``nccl`` and
    ``'cpu'`` otherwise by default; a mesh of ``'cpu'`` type over ``gloo``
    also carries ranks whose tensors live on a card.
    """
    from torch.distributed.device_mesh import init_device_mesh
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError('make_mesh: no process group; call initialize_distributed first')
    world = dist.get_world_size()
    shape = (world,) if shape is None else tuple(shape)
    if tuple(axis_names) != ('data',) or shape != (world,):
        raise ValueError(f'make_mesh: the port has one mesh dimension, \'data\', over all '
                         f'{world} ranks; got shape {shape} and axes {tuple(axis_names)}')
    if device_type is None:
        device_type = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    return init_device_mesh(device_type, shape, mesh_dim_names=('data',))


def mesh_group(mesh):
    """The process group of a mesh's ``'data'`` dimension (``mesh`` may also
    be a process group, or None for the default group)."""
    if mesh is None or not hasattr(mesh, 'get_group'):
        return mesh
    return mesh.get_group('data')


def host_group(group=None):
    """A ``gloo`` group over the ranks of ``group`` (the default group when
    None): ``group`` itself where it is ``gloo``. Made once per group; every
    rank of the group must reach the first call together."""
    if dist.get_backend(group) == 'gloo':
        return group
    key = None if group is None else id(group)
    if key not in _HOST_GROUP:
        ranks = None if group is None else dist.get_process_group_ranks(group)
        _HOST_GROUP[key] = dist.new_group(ranks=ranks, backend='gloo')
    return _HOST_GROUP[key]


def _world(group=None) -> int:
    return dist.get_world_size(group) if dist.is_available() and dist.is_initialized() else 1


def get_rank() -> int:
    """This process's rank: ``torch.distributed``'s, else 0."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def get_num_nodes() -> int:
    """The number of processes: ``torch.distributed``'s world size, else 1."""
    return _world()


def cpu_count() -> int:
    """Usable CPUs: ``SLURM_CPUS_PER_TASK`` where set, else ``os.cpu_count()``."""
    slurm = os.environ.get('SLURM_CPUS_PER_TASK')
    return int(slurm) if slurm else (os.cpu_count() or 1)


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


def _all_gather_host(t: torch.Tensor, group=None) -> torch.Tensor:
    """``[world, *t.shape]``: every rank's CPU tensor ``t`` (equal shapes)."""
    out = [torch.empty_like(t) for _ in range(_world(group))]
    dist.all_gather(out, t, group=host_group(group))
    return torch.stack(out)


def all_filter(condition: bool, group=None):
    """``(ranks where condition holds, ranks where it does not)``, the same
    sets on every rank (MPI ``all_filter`` without the communicator)."""
    n = _world(group)
    if n <= 1:
        return ({0} if condition else set()), (set() if condition else {0})
    flags = _all_gather_host(torch.tensor([int(bool(condition))]), group).reshape(-1)
    keep = {i for i, f in enumerate(flags.tolist()) if f}
    return keep, set(range(n)) - keep


def host_all_reduce_sum(values: np.ndarray, group=None) -> np.ndarray:
    """Sum a small host array over the ranks (the identity on one process);
    :class:`..data.instance_eval.LabelMatcherList`'s ``reduce_fn``."""
    values = np.asarray(values)
    if _world(group) <= 1:
        return values
    t = torch.from_numpy(np.ascontiguousarray(values)).clone()
    dist.all_reduce(t, group=host_group(group))
    return t.numpy()


def broadcast_from_rank0(obj, group=None):
    """Rank 0's picklable ``obj`` on every rank (the identity on one process)."""
    if _world(group) <= 1:
        return obj
    box = [obj]
    g = host_group(group)
    dist.broadcast_object_list(box, src=dist.get_global_rank(g, 0) if g is not None else 0,
                               group=g)
    return box[0]
