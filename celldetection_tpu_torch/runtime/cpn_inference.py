"""Batch tiled inference and its command line (``cdt-inference-cpn-torch``).

Counterpart of ``celldetection_tpu/runtime/cpn_inference.py``: ``preprocess``
(26-47), ``resolve_model`` (50-73), ``_ensemble`` (76-107), ``_load_inputs``
(110-119), ``cpn_inference`` (122-339) and ``main`` (342-404), with the same
flags and defaults. Each input runs through two functions in turn:
:func:`infer_input` computes (loads and preprocesses the image, runs the tiled
inference on the model's device, and builds the label images, the property
table and the overlay) and :func:`write_outputs` writes the files (h5 with
``contours``, ``scores``, ``boxes``, ``classes``, ``labels``, ``flat_labels``
and the ``args`` attribute; ``<name>.csv``; ``<name>_overlay.tiff``).
Writing needs h5py, and imageio or tifffile for the overlay; reading image
files needs imageio (or tifffile).

Over several processes (one card each, as Lightning's ``devices=N`` runs
the reference): ``devices=N`` starts N ranks (:func:`spawn_ranks`), or the
caller starts them (torchrun, Slurm) and initialises ``torch.distributed``
(:func:`..parallel.mesh.initialize_distributed`). ``group_level`` splits the
work: ``'rank'`` gives each input to one rank; ``'job'`` runs every input on
all ranks, each mosaic's tiles split over them
(:func:`..parallel.tiles.multihost_tiled_inference`), and rank 0 writes;
``'node'`` gives each input to one node and splits its tiles over that
node's ranks. Each input has exactly one writer. ``demo_figure`` writes
``<name>_demo.png`` (matplotlib, imported only then).
"""
import argparse
import glob as glob_mod
import json
import os
import pickle
import socket
import tempfile
import time
from typing import List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from ..data.misc import normalize_percentile
from ..ops.boxes import filter_by_box_voting, nms_padded
from ..parallel.tiles import KEYS, TiledInference, tta_inference

__all__ = ['cpn_inference', 'preprocess', 'resolve_model', 'resolve_accelerator',
           'tiled_models', 'infer_input', 'write_outputs', 'spawn_ranks', 'main']


def preprocess(img: np.ndarray, percentile: Optional[float] = None, gamma: float = 1.,
               contrast: float = 1., brightness: float = 0., to_rgb: bool = True) -> np.ndarray:
    """Normalise an input mosaic to float32 in [0, 1].

    uint8 inputs scale by 255; other dtypes are percentile-normalised (99.9
    when unset). Then optional gamma, contrast and brightness, and gray to RGB.
    """
    if img.dtype == np.uint8 and percentile is None:
        img = img.astype(np.float32) / 255.
    else:
        img = normalize_percentile(img, percentile if percentile is not None else 99.9)
    if gamma != 1.:
        img = np.clip(img, 0, 1) ** gamma
    if contrast != 1. or brightness != 0.:
        img = np.clip(img * contrast + brightness, 0., 1.)
    if to_rgb:
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, -1)
    return img.astype(np.float32)


def resolve_model(model: Union[str, object], model_parameters: Optional[str] = None,
                  input_shape=None, device=None, **kwargs):
    """A CPN from an instance, a cdt/``.pt``/``.ckpt`` path or a hosted name.

    Args:
        model_parameters: Comma-separated ``key=value`` attribute overrides,
            each typed by the attribute's current value (float where it is
            None; ``1``/``true`` for a bool), e.g. ``"score_thresh=0.86,samples=128"``.
        input_shape: Accepted for the JAX package's signature; a port model
            needs no init template.
        device: Where a loaded model lives (an instance is moved there);
            ``cuda`` by default.
        kwargs: Overrides of the stored hyperparameters of a loaded model.
    """
    from ..util.serialization import fetch_model, load_model
    if isinstance(model, str):
        load = load_model if os.path.isfile(model) else fetch_model
        model = load(model, device=device, **kwargs)
    elif device is not None:
        model.to(device)
    if model_parameters:
        for spec in model_parameters.split(','):
            k, v = spec.split('=')
            k = k.strip()
            if hasattr(model, k):
                cur = getattr(model, k)
                typ = type(cur) if cur is not None else float
                setattr(model, k, typ(v) if typ is not bool else v.lower() in ('1', 'true'))
    return model


def resolve_accelerator(accelerator: Optional[str] = None) -> torch.device:
    """This process's device for ``accelerator``: the card for None,
    ``'auto'``, ``'gpu'`` and ``'cuda'`` (``cuda:{LOCAL_RANK}`` in a process
    group; raises without a card), the CPU for ``'cpu'``, or the device a
    ``'cuda:N'`` names."""
    from ..parallel.mesh import local_rank
    from ..util.device import resolve_device
    if accelerator in (None, 'auto', 'gpu', 'cuda'):
        grouped = dist.is_available() and dist.is_initialized()
        return resolve_device(f'cuda:{local_rank()}' if grouped else 'cuda')
    if accelerator == 'cpu' or str(accelerator).startswith('cuda:'):
        return resolve_device(accelerator)
    raise ValueError(f"accelerator={accelerator!r}: the port runs on 'gpu'/'cuda' (the "
                     f"default), 'cuda:N' or 'cpu'")


def tiled_models(model, device, precision: str = '32', score_thresh: Optional[float] = None,
                 nms_thresh: Optional[float] = None, model_parameters: Optional[str] = None,
                 model_kwargs: Optional[str] = None, tile_size: int = 1024, stride: int = 768,
                 batch_size: Optional[int] = None, border_removal: int = 4,
                 stitching_rule: str = 'nms', mesh=None) -> List[TiledInference]:
    """The models of :func:`cpn_inference` on ``device``, each in a
    :class:`..parallel.tiles.TiledInference`: ``model`` (or each of a list
    or tuple, an ensemble) through :func:`resolve_model` with
    ``model_parameters`` and the JSON ``model_kwargs``, then ``precision``
    (``'bf16'`` computes the backbone and heads in bfloat16) and the
    threshold overrides. ``mesh``: the ranks that split each mosaic's tiles
    (:class:`..parallel.tiles.TiledInference`)."""
    mk = json.loads(model_kwargs) if model_kwargs else {}
    model_list = model if isinstance(model, (list, tuple)) else [model]
    model_list = [resolve_model(m, model_parameters, device=device, **mk) for m in model_list]
    for m in model_list:
        if precision in ('bf16', 'bfloat16', '16'):
            m.compute_dtype = torch.bfloat16
        if score_thresh is not None:
            m.score_thresh = score_thresh
        if nms_thresh is not None:
            m.nms_thresh = nms_thresh
    return [TiledInference(m, tile_size=tile_size, stride=stride, batch_size=batch_size,
                           border_removal=border_removal, stitching_rule=stitching_rule, mesh=mesh)
            for m in model_list]


def _ensemble(tiled_list, img, mask, pmask, min_vote: int, nms_thresh: float, reps: int = 1,
              point_mask_exclusive: bool = False) -> dict:
    """Multi-model ensemble: the models' detections concatenated, box voting,
    one final NMS on the first model's device."""
    if reps > 1:
        results = [tta_inference(t, img, reps=reps, mask=mask, point_mask=pmask,
                                 point_mask_exclusive=point_mask_exclusive) for t in tiled_list]
    else:
        results = [t(img, mask=mask, point_mask=pmask, point_mask_exclusive=point_mask_exclusive)
                   for t in tiled_list]
    cat = {k: np.concatenate([r[k] for r in results]) for k in KEYS
           if results[0].get(k) is not None}
    n = len(cat['boxes'])
    if n == 0:
        return dict(results[0])
    dev = tiled_list[0].model.device
    boxes = torch.from_numpy(np.ascontiguousarray(cat['boxes'])).to(dev)
    scores = torch.from_numpy(np.ascontiguousarray(cat['scores'])).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    if min_vote > 1:
        valid = filter_by_box_voting(boxes, nms_thresh, min_vote, valid)
    keep = nms_padded(boxes, scores, valid, nms_thresh).cpu().numpy()
    out = {k: v[keep] for k, v in cat.items()}
    out['num_tiles'] = sum(r.get('num_tiles', 0) for r in results)
    return out


def _load_inputs(inputs: Union[str, Sequence[str]]) -> List[str]:
    if isinstance(inputs, str):
        inputs = [inputs]
    files = []
    for i in inputs:
        if any(c in i for c in '*?['):
            files += sorted(glob_mod.glob(i))
        else:
            files.append(i)
    return files


def infer_input(src, tiled_list: Sequence[TiledInference], mask=None, point_mask=None, *,
                name: str = None, percentile: Optional[float] = None, gamma: float = 1.,
                contrast: float = 1., brightness: float = 0., grayscale: bool = False,
                inputs_method: str = 'imageio', inputs_dataset: str = 'image',
                masks_dataset: str = 'mask', point_masks_dataset: str = 'point_mask',
                point_mask_exclusive: bool = False, min_vote: int = 1, reps: int = 1,
                labels: bool = False, flat_labels: bool = False,
                properties: Optional[List[str]] = None, spacing=None, separator: str = '-',
                overlay: bool = False, overlay_processes: Optional[int] = None,
                overlay_seed: Optional[int] = None, demo_figure: bool = False) -> dict:
    """Everything :func:`cpn_inference` computes for one input, nothing written.

    Args:
        src: An image array, or a file name for :func:`..util.io.load_image`
            (``file.h5::key``, or ``inputs_dataset`` for a plain ``.h5``).
        tiled_list: One :class:`..parallel.tiles.TiledInference` per model;
            more than one is an ensemble (box voting by ``min_vote``, one
            final NMS).
        mask, point_mask: Optional arrays or file names, paired with ``src``.
        overlay_seed: The seed of the overlay's random colours (None, as
            :func:`cpn_inference` draws them, gives other colours each call).
        demo_figure: Keep the preprocessed image's first channel as ``demo``
            for :func:`write_outputs`' figure.
        Other arguments as :func:`cpn_inference`'s.

    Returns:
        ``name``, ``size`` (h, w), ``result`` (the tiled inference's
        detections), ``labels``, ``flat_labels``, ``table`` (a
        :class:`..data.misc.PropertyTable`), ``overlay`` and ``demo``, each
        None unless asked for, and ``seconds`` by stage on the host clock (``load``,
        ``preprocess``, ``inference``, ``labels``, ``flat_labels``,
        ``table``, ``overlay``) beside ``stats``, the tiled inference's own
        (the first model's).
    """
    from ..data.cpn import contours2labels, contours2overlay
    from ..util.io import load_image

    seconds = {}
    t0 = time.perf_counter()
    img = load_image(src, method=inputs_method, dataset=inputs_dataset) \
        if isinstance(src, str) else np.asarray(src)
    if grayscale and img.ndim == 3 and img.shape[-1] > 1:
        # the dtype stays: uint8 inputs must keep preprocess's /255 branch
        img = img.mean(-1).astype(img.dtype)
    mask = load_image(mask, dataset=masks_dataset) if isinstance(mask, str) else mask
    point_mask = load_image(point_mask, dataset=point_masks_dataset) \
        if isinstance(point_mask, str) else point_mask
    seconds['load'] = time.perf_counter() - t0

    t0 = time.perf_counter()
    model = tiled_list[0].model
    to_rgb = model.hparams.get('in_channels', 3) != 1   # gray to RGB for multi-channel models
    img = preprocess(img, percentile=percentile, gamma=gamma, contrast=contrast,
                     brightness=brightness, to_rgb=to_rgb)
    seconds['preprocess'] = time.perf_counter() - t0

    t0 = time.perf_counter()
    kw = dict(mask=mask, point_mask=point_mask, point_mask_exclusive=point_mask_exclusive)
    if len(tiled_list) > 1:
        res = _ensemble(tiled_list, img, mask, point_mask, min_vote, model.nms_thresh, reps=reps,
                        point_mask_exclusive=point_mask_exclusive)
    elif reps > 1:
        res = tta_inference(tiled_list[0], img, reps=reps, **kw)
    else:
        res = tiled_list[0](img, **kw)
    seconds['inference'] = time.perf_counter() - t0
    h, w = img.shape[:2]
    out = dict(name=name, size=(h, w), result=res, labels=None, flat_labels=None, table=None,
               overlay=None, seconds=seconds, stats=dict(tiled_list[0].stats),
               demo=(img[..., 0] if img.ndim == 3 else img) if demo_figure else None)

    contours = list(res['contours'])
    if labels:
        t0 = time.perf_counter()
        out['labels'] = contours2labels(contours, (h, w))
        seconds['labels'] = time.perf_counter() - t0
    if flat_labels or properties:
        from ..native import contours2labels_native
        t0 = time.perf_counter()
        flat = contours2labels_native(contours, (h, w))
        seconds['flat_labels'] = time.perf_counter() - t0
        if flat_labels:
            out['flat_labels'] = flat
        if properties:
            from ..data.misc import labels2property_table
            t0 = time.perf_counter()
            out['table'] = labels2property_table(flat, *properties, spacing=spacing,
                                                 separator=separator)
            seconds['table'] = time.perf_counter() - t0
    if overlay:
        t0 = time.perf_counter()
        out['overlay'] = contours2overlay(res['contours'], (h, w), seed=overlay_seed,
                                          processes=overlay_processes)
        seconds['overlay'] = time.perf_counter() - t0
    return out


def write_outputs(outputs: str, computed: dict, args: dict):
    """Write what :func:`infer_input` computed for one input into the
    directory ``outputs``: ``<name>.h5`` (detections, label images, the
    ``args`` attribute as JSON), ``<name>.csv``, ``<name>_overlay.tiff`` and
    ``<name>_demo.png``, the contours over the image (matplotlib)."""
    from ..util.io import to_h5, to_tiff
    name, res = computed['name'], computed['result']
    out_fn = os.path.join(outputs, f'{name}.h5')
    to_h5(out_fn, contours=res['contours'], scores=res['scores'], boxes=res['boxes'],
          classes=res['classes'], attributes={'args': json.dumps(args)})
    for key in ('labels', 'flat_labels'):
        if computed[key] is not None:
            to_h5(out_fn, mode='a', **{key: computed[key]})
    if computed['table'] is not None:
        computed['table'].to_csv(os.path.join(outputs, f'{name}.csv'))
    if computed['overlay'] is not None:
        to_tiff(os.path.join(outputs, f'{name}_overlay.tiff'), computed['overlay'])
    if computed.get('demo') is not None:
        from ..visualization.images import save_fig, show_detection
        ax = show_detection(image=computed['demo'], contours=list(res['contours']))
        save_fig(os.path.join(outputs, f'{name}_demo.png'), ax.figure)


def cpn_inference(
        inputs, model, outputs: str = 'outputs', masks=None, point_masks=None,
        tile_size: int = 1024, stride: int = 768,
        batch_size: Optional[int] = None, precision: str = '32', border_removal: int = 4,
        stitching_rule: str = 'nms', min_vote: int = 1, score_thresh: Optional[float] = None,
        nms_thresh: Optional[float] = None, percentile: Optional[float] = None,
        gamma: float = 1., contrast: float = 1., brightness: float = 0.,
        group_level: str = 'rank', model_parameters: Optional[str] = None,
        labels: bool = False, flat_labels: bool = False, properties: Optional[List[str]] = None,
        overlay: bool = False, overlay_processes: int = None,
        demo_figure: bool = False, continue_on_exception: bool = False,
        reps: int = 1,
        accelerator: Optional[str] = None, devices=None, num_nodes: int = 1,
        grayscale: bool = False, inputs_method: str = 'imageio', separator: str = '-',
        inputs_dataset: str = 'image', masks_dataset: str = 'mask',
        point_masks_dataset: str = 'point_mask', point_mask_exclusive: bool = False,
        skip_existing: bool = False, truncated_images: bool = False,
        model_kwargs: Optional[str] = None, spacing=None,
        rank_devices: Optional[Sequence[str]] = None, backend: Optional[str] = None,
        _with_indices: bool = False,
):
    """Run tiled CPN inference on large input images and write the results.

    Args (those of the JAX package's CLI):
        inputs: File name(s), glob pattern(s), or arrays.
        model: Model name, path or instance (see :func:`resolve_model`); a
            list or tuple of them is an ensemble.
        outputs: Output directory (an h5 per input, and optional files).
        tile_size / stride: The sliding window (1024 / 768).
        precision: ``'32'`` or ``'bf16'`` (the backbone's and heads' dtype).
        border_removal: Interior tile-border margin in px.
        stitching_rule: ``'nms'`` and/or ``'ex_br'`` (comma-separated).
        score_thresh / nms_thresh: Optional model overrides.
        group_level: ``'rank'`` (each input on one rank), ``'node'`` (each
            input on one node, its tiles split over the node's ranks) or
            ``'job'`` (every input on every rank, its tiles split over them);
            with one process every input is this process's.
        labels / flat_labels: Also write the channelled and the flat label image.
        properties: Region properties to write as CSV (``separator`` joins
            the columns of a vector property, as ``bbox-0``; ``spacing``
            gives physical units).
        overlay: Write an RGBA overlay TIFF (``overlay_processes`` workers).
        demo_figure: Write ``<name>_demo.png``: the contours over the image.
        reps: Test-time augmentation over flips (1-4).
        accelerator: None, ``'auto'``, ``'gpu'`` or ``'cuda'`` (the card),
            ``'cuda:N'`` or ``'cpu'`` (:func:`resolve_accelerator`).
        devices: In a process that is no rank of a group, ``devices=N > 1``
            runs the call on N new ranks (:func:`spawn_ranks`), one card each
            (more than the visible cards raise unless ``rank_devices`` names
            each rank's device, e.g. ``['cuda:0', 'cuda:0']``, or the
            accelerator is ``'cpu'``); ``backend`` overrides their
            ``nccl``/``gloo``. In a rank of a group, the ranks of its node.
        num_nodes: The expected number of processes (1 accepts any).
        grayscale: Average multi-channel inputs (the dtype stays).
        inputs_dataset / masks_dataset / point_masks_dataset: The h5 keys of
            ``.h5`` inputs named without ``::key``.
        point_mask_exclusive: Detect only at marked points.
        skip_existing: Skip inputs whose h5 exists.
        continue_on_exception: Print an input's error and go on.
        model_kwargs: JSON of overrides for loading the model(s).

    Returns:
        The list of this rank's per-input results (the tiled inference's
        detections); from :func:`spawn_ranks`, every input's, in input order.
    """
    call = {k: v for k, v in locals().items()
            if k not in ('devices', 'rank_devices', 'backend', '_with_indices')}
    from ..parallel.mesh import broadcast_from_rank0, get_num_nodes, shard_inputs_by_process

    grouped = dist.is_available() and dist.is_initialized()
    if devices is not None and int(devices) > 1 and not grouped:
        return spawn_ranks(int(devices), call, rank_devices, backend)
    world = get_num_nodes()
    if int(num_nodes) not in (1, world):
        raise ValueError(f'num_nodes={num_nodes} but {world} process(es) run: start one process '
                         f'per rank (torchrun, or devices=N)')
    local_world = int(os.environ.get('LOCAL_WORLD_SIZE', world))
    if grouped and devices is not None and int(devices) not in (1, local_world):
        raise ValueError(f'devices={devices} but this node runs {local_world} rank(s)')
    device = resolve_accelerator(accelerator)
    os.makedirs(outputs, exist_ok=True)
    if truncated_images:
        try:
            from PIL import ImageFile
        except ImportError as e:
            raise ImportError('truncated_images needs the package PIL') from e
        ImageFile.LOAD_TRUNCATED_IMAGES = True

    # the ranks that share each input: all under 'job', the node's under
    # 'node', this one alone under 'rank'
    share = None
    if world > 1 and group_level == 'job':
        share = dist.group.WORLD
    elif world > 1 and group_level == 'node':
        share = _node_group()
    if share is not None and dist.get_world_size(share) == 1:
        share = None
    writer = share is None or dist.get_rank(share) == 0
    tiled_list = tiled_models(model, device, precision, score_thresh, nms_thresh,
                              model_parameters, model_kwargs, tile_size, stride, batch_size,
                              border_removal, stitching_rule, mesh=share)

    if isinstance(inputs, np.ndarray):
        file_list = [inputs]
    elif isinstance(inputs, (list, tuple)) and len(inputs) and isinstance(inputs[0], np.ndarray):
        file_list = list(inputs)
    else:
        file_list = _load_inputs(inputs)
    mask_list = _load_inputs(masks) if masks else None
    point_list = _load_inputs(point_masks) if point_masks else None
    file_list = shard_inputs_by_process(list(enumerate(file_list)), group_level)
    args = dict(tile_size=tile_size, stride=stride, border_removal=border_removal,
                stitching_rule=stitching_rule, precision=precision)

    results = []
    for src_idx, src in file_list:
        name = (os.path.splitext(os.path.basename(src))[0]
                if isinstance(src, str) else f'array{src_idx}')
        try:
            if skip_existing:
                exists = os.path.isfile(os.path.join(outputs, f'{name}.h5'))
                if share is not None:   # the ranks that share the input decide as one
                    exists = broadcast_from_rank0(exists, share)
                if exists:
                    continue
            computed = infer_input(
                src, tiled_list, mask_list[src_idx] if mask_list else None,
                point_list[src_idx] if point_list else None, name=name, percentile=percentile,
                gamma=gamma, contrast=contrast, brightness=brightness, grayscale=grayscale,
                inputs_method=inputs_method, inputs_dataset=inputs_dataset,
                masks_dataset=masks_dataset, point_masks_dataset=point_masks_dataset,
                point_mask_exclusive=point_mask_exclusive, min_vote=min_vote, reps=reps,
                labels=labels, flat_labels=flat_labels, properties=properties, spacing=spacing,
                separator=separator, overlay=overlay, overlay_processes=overlay_processes,
                demo_figure=demo_figure)
            if writer:
                write_outputs(outputs, computed, args)
            results.append((src_idx, computed['result']) if _with_indices else computed['result'])
        except Exception as e:
            if continue_on_exception:
                print(f'cpn_inference: skipping {name}: {type(e).__name__}: {e}')
                continue
            raise
    return results


def _node_group():
    """This rank's node as a process group (:func:`..parallel.mesh._node_topology`);
    every rank makes every node's group, in node order."""
    from ..parallel.mesh import _node_topology, host_group
    world = dist.get_world_size()
    node = torch.tensor([_node_topology()[0]])
    nodes = [torch.zeros_like(node) for _ in range(world)]
    dist.all_gather(nodes, node, group=host_group())
    nodes = [int(n) for n in nodes]
    mine = None
    for n in sorted(set(nodes)):
        g = dist.new_group([r for r in range(world) if nodes[r] == n])
        if n == nodes[dist.get_rank()]:
            mine = g
    return mine


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _rank_main(rank: int, port: int, devices: Sequence[str], backend: Optional[str], call: dict,
               out_dir: str):
    from ..parallel.mesh import initialize_distributed
    if torch.device(devices[rank]).type == 'cpu' and 'OMP_NUM_THREADS' not in os.environ:
        # as torchrun does: CPU ranks share the cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // len(devices)))
    initialize_distributed(f'localhost:{port}', len(devices), rank, backend=backend,
                           device=devices[rank])
    try:
        indexed = cpn_inference(**dict(call, accelerator=devices[rank]), _with_indices=True)
        with open(os.path.join(out_dir, f'rank{rank}.pkl'), 'wb') as f:
            pickle.dump(indexed, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(n: int, call: dict, rank_devices: Optional[Sequence[str]] = None,
                backend: Optional[str] = None) -> list:
    """Run ``cpn_inference(**call)`` on ``n`` new processes (``spawn``), ranks of
    one ``torch.distributed`` group over ``localhost``, as Lightning's
    ``devices=N`` runs the reference.

    Rank ``r`` runs on ``rank_devices[r]`` where given, else on the CPU for
    ``accelerator='cpu'``, else on ``cuda:r``: more ranks than visible cards
    raise. A rank that fails ends the others and raises here.

    Returns:
        Every input's result, in input order (under ``'job'`` and ``'node'``
        the first rank's copy).
    """
    import torch.multiprocessing as mp
    if rank_devices is None:
        if call.get('accelerator') == 'cpu':
            rank_devices = ['cpu'] * n
        else:
            cards = torch.cuda.device_count()
            if cards < n:
                raise ValueError(f'devices={n} but {cards} card(s) are visible; name each '
                                 f'rank\'s device with rank_devices (e.g. cuda:0 twice)')
            rank_devices = [f'cuda:{r}' for r in range(n)]
    if len(rank_devices) != n:
        raise ValueError(f'devices={n} but {len(rank_devices)} rank_devices')
    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(_rank_main, args=(_free_port(), list(rank_devices), backend, call,
                                             out_dir), nprocs=n, start_method='spawn')
        merged = {}
        for r in range(n):
            with open(os.path.join(out_dir, f'rank{r}.pkl'), 'rb') as f:
                for idx, res in pickle.load(f):
                    merged.setdefault(idx, res)
    return [merged[i] for i in sorted(merged)]


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser('cdt-inference-cpn-torch',
                                description='Tiled CPN inference on a CUDA card or the CPU '
                                            '(celldetection_tpu_torch)')
    p.add_argument('-i', '--inputs', nargs='+', required=True,
                   help='Input files or glob patterns')
    p.add_argument('-m', '--model', nargs='+', required=True,
                   help='Model name(s)/checkpoint path(s); multiple -> ensemble with box voting')
    p.add_argument('-o', '--outputs', default='outputs', help='Output directory')
    p.add_argument('--masks', nargs='*', default=None,
                   help='Optional fg masks (paired with inputs); suppress detections outside')
    p.add_argument('--point_masks', nargs='*', default=None,
                   help='Optional point-prompt masks (paired with inputs)')
    p.add_argument('--tile_size', type=int, default=1024)
    p.add_argument('--stride', type=int, default=768)
    p.add_argument('--batch_size', type=int, default=None)
    p.add_argument('--precision', default='32', choices=['32', 'bf16'])
    p.add_argument('--border_removal', type=int, default=4)
    p.add_argument('--stitching_rule', default='nms')
    p.add_argument('--score_thresh', type=float, default=None)
    p.add_argument('--nms_thresh', type=float, default=None)
    p.add_argument('--percentile', type=float, default=None)
    p.add_argument('--gamma', type=float, default=1.)
    p.add_argument('--contrast', type=float, default=1.)
    p.add_argument('--brightness', type=float, default=0.)
    p.add_argument('--group_level', default='rank', choices=['job', 'rank', 'node'])
    p.add_argument('--model_parameters', default=None,
                   help='Comma-separated key=value model attribute overrides')
    p.add_argument('--labels', action='store_true')
    p.add_argument('--flat_labels', action='store_true')
    p.add_argument('-p', '--properties', nargs='*', default=None)
    p.add_argument('--overlay', action='store_true')
    p.add_argument('--overlay_processes', type=int, default=None,
                   help='Parallel overlay rendering processes (gigapixel outputs)')
    p.add_argument('--demo_figure', action='store_true')
    p.add_argument('--continue_on_exception', action='store_true')
    p.add_argument('--reps', type=int, default=1,
                   help='Test-time augmentation over flips (1-4)')
    p.add_argument('--accelerator', default=None,
                   help="'gpu'/'cuda' (the default) or 'cpu'")
    p.add_argument('--devices', type=int, default=None,
                   help='Ranks to start, one card each (or the ranks of this node)')
    p.add_argument('--num_nodes', type=int, default=1)
    p.add_argument('--rank_devices', nargs='+', default=None,
                   help='Each started rank\'s device (e.g. cuda:0 cuda:0)')
    p.add_argument('--backend', default=None, help='nccl or gloo for the started ranks')
    p.add_argument('--min_vote', type=int, default=1,
                   help='Ensemble box voting: min models that must agree')
    p.add_argument('--grayscale', action='store_true',
                   help='Convert multi-channel inputs to grayscale')
    p.add_argument('--inputs_method', default='imageio', choices=['imageio', 'tifffile'])
    p.add_argument('--separator', default='-',
                   help='Column separator for multi-valued region properties in CSVs')
    p.add_argument('--inputs_dataset', default='image', help='Default h5 key for inputs')
    p.add_argument('--masks_dataset', default='mask', help='Default h5 key for masks')
    p.add_argument('--point_masks_dataset', default='point_mask',
                   help='Default h5 key for point masks')
    p.add_argument('--point_mask_exclusive', action='store_true',
                   help='Only detect at point-marked pixels')
    p.add_argument('--skip_existing', action='store_true',
                   help='Skip inputs whose output h5 already exists')
    p.add_argument('--truncated_images', action='store_true',
                   help='Tolerate truncated image files (PIL)')
    p.add_argument('--model_kwargs', default=None,
                   help='JSON kwargs for model construction')
    p.add_argument('--spacing', type=float, nargs='+', default=None,
                   help='Physical pixel spacing for property export')
    args = vars(p.parse_args(argv))
    if not (dist.is_available() and dist.is_initialized()):
        # under torchrun or Slurm (WORLD_SIZE / SLURM_NTASKS above 1) this
        # process is one rank: join the others
        from ..parallel.mesh import initialize_distributed
        acc = args['accelerator']
        initialize_distributed(backend=args['backend'], device=acc if acc == 'cpu' or str(
            acc).startswith('cuda:') else None)
    cpn_inference(**args)


if __name__ == '__main__':
    main()
