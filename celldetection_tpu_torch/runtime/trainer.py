"""CPN training, validation and prediction, on one card or data-parallel over ranks.

Counterpart of ``celldetection_tpu/runtime/trainer.py``: ``CPNTrainer`` with
``__init__`` (49-85), ``_make_batch`` (89-122), ``fit`` (124-253, its
multi-process epochs at 163-214), ``gather_item_records`` (255-278),
``validate`` (282-357, ``distributed`` at 293-300), the hyperparameters of
prediction (360-377), ``predict`` (379-401) and the msgpack checkpoints
(420-482). With a ``mesh`` (:func:`..parallel.mesh.make_mesh`) the trainer
runs on every rank of it, one card each; the metrics logger and figure
logging belong to a later slice of the port and raise here.
"""
import os
import time
from concurrent.futures import ThreadPoolExecutor
from itertools import product
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..data.cpn import contours2labels
from ..data.instance_eval import LabelMatcher, LabelMatcherList
from ..data.misc import random_crop, random_pad
from ..data.targets import collate_cpn_targets, cpn_targets_single
from ..parallel.mesh import host_all_reduce_sum, host_group, mesh_group, shard_inputs_by_process
from ..parallel.train import TrainState, make_train_step, mesh_spans_processes
from ..util._msgpack import msgpack_restore, msgpack_serialize, packb, unpackb
from ..util.config import conf2optimizer
from ..util.weights import body_layout, jax_variables_from_state_dict, state_dict_from_jax

__all__ = ['CPNTrainer']

def _numpy_tree(obj):
    """A state dict with every tensor as a numpy array (msgpack-ready)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _numpy_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_numpy_tree(v) for v in obj]
    return obj


def _torch_tree(obj):
    """The inverse of :func:`_numpy_tree`: numpy arrays become CPU tensors."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.array(obj))
    if isinstance(obj, dict):
        return {k: _torch_tree(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_torch_tree(v) for v in obj]
    return obj


class CPNTrainer:
    """Training and prediction of a CPN of the port.

    Args:
        model: A :class:`..models.cpn.CPN` on its device.
        optimizer: A ``torch.optim.Optimizer`` over the model's parameters,
            a factory ``params -> optimizer``, or a config such as
            ``{'Adam': {'lr': 1e-3}}`` (:func:`..util.config.conf2optimizer`);
            Adam at 1e-3 when None.
        scheduler: Optional ``step -> lr multiplier`` (:mod:`..optim`,
            :func:`..util.config.conf2scheduler`); step 0 is the first update.
        val_hparams: The sweep of :meth:`validate`, model attributes to
            their values, e.g. ``{'score_thresh': [.5, .86, .88, .9, .92]}``
            (the default, as the reference's ``lightning_cpn.py:36-39``).
        checkpoint_dir: :meth:`fit` writes ``last.ckpt`` there every epoch.
        max_imsize: :meth:`predict` and :meth:`validate` tile inputs larger
            than this.
        ema_decay: Decay of the loss's moving average.
        seed: Seeds the host pipeline (shuffles, per-item seeds) and the
            ``torch.Generator`` of the training steps' random draws (rank
            ``r`` of a mesh seeds its generator with ``seed + r``).
        mesh: Optional ``DeviceMesh`` (or process group) of ranks, one card
            each: every rank builds the same trainer and calls :meth:`fit`
            with the same data; each trains on its slice of every batch
            (:func:`..parallel.train.make_train_step`).
    """

    def __init__(self, model, optimizer=None, scheduler: Optional[Callable[[int], float]] = None,
                 val_hparams: Optional[Dict[str, Sequence]] = None, mesh=None,
                 checkpoint_dir: Optional[str] = None, max_imsize: int = 2048,
                 tile_size: int = 1024, tile_stride: int = 512, ema_decay: float = 0.99,
                 log_fn: Callable = print, seed: int = 0, metrics_logger=None,
                 log_figures_every: int = 0):
        if metrics_logger is not None or log_figures_every:
            raise NotImplementedError('the metrics logger and figure logging are not ported '
                                      'yet; they come with the slice of the command-line '
                                      'interface')
        self.model = model
        self.val_hparams = val_hparams or {'score_thresh': [.5, .86, .88, .9, .92]}
        self.checkpoint_dir = checkpoint_dir
        if optimizer is None:
            optimizer = conf2optimizer({'Adam': {'lr': 1e-3}})
        elif isinstance(optimizer, dict):
            optimizer = conf2optimizer(optimizer)
        self.mesh = mesh
        self.state = TrainState.create(model, optimizer, scheduler)
        self._step_fn = make_train_step(model, self.state.optimizer, mesh=mesh,
                                        scheduler=self.state.scheduler)
        self.max_imsize = max_imsize
        self.tile_size = tile_size
        self.tile_stride = tile_stride
        self.ema_decay = ema_decay
        self.log_fn = log_fn
        self.seed = seed
        rank = dist.get_rank(mesh_group(mesh)) if mesh_spans_processes(mesh) else 0
        self.generator = torch.Generator(device=model.device).manual_seed(seed + rank)
        self._np_seed_counter = 0
        self._ema_loss = None
        self._tiled = None
        self.history: List[dict] = []
        self.best_hparams: Dict[str, float] = {}
        # what the last validate() measured: per setting its metrics and
        # per-image counts, and the seconds of its stages
        self.val_results: List[dict] = []
        self.val_seconds: Dict[str, float] = {}

    # --- training -----------------------------------------------------------

    def _make_batch(self, train_data, idx, samples, order, max_instances, rng_np,
                    crop_size=None, item_seeds=None):
        """Host-side batch of items ``idx``: crops, targets, stacked numpy arrays.

        Each item draws from its own ``RandomState`` seeded from
        ``item_seeds`` (drawn from ``rng_np`` when None), so an item's crop
        and sampling do not depend on the batch it is built in.
        """
        if item_seeds is None:
            item_seeds = rng_np.randint(2 ** 31, size=len(idx))
        images, items = [], []
        for i, seed in zip(idx, item_seeds):
            rng_i = np.random.RandomState(int(seed))
            item = train_data[int(i)]
            # (image, labels) or (image, labels, per-instance classes)
            image, labels = item[0], item[1]
            classes = item[2] if len(item) > 2 else None
            if image.ndim == 2:
                image = image[..., None]
            if crop_size is not None:
                image, labels = random_crop(image, labels, height=crop_size, rng=rng_i)
                if image.shape[0] < crop_size or image.shape[1] < crop_size:
                    image, labels = random_pad(image, labels, height=crop_size, rng=rng_i)
            items.append(cpn_targets_single(np.ascontiguousarray(labels), samples, order,
                                            rng=rng_i, classes=classes))
            images.append(np.asarray(image, np.float32))
        targets = collate_cpn_targets(items, max_instances=max_instances)
        return {'image': np.stack(images),
                **{k: v for k, v in targets.items() if k != 'num_instances'}}

    def fit(self, train_data, epochs: int = 1, batch_size: int = 4,
            max_instances: int = 128, val_data=None, val_every: int = 1,
            samples: Optional[int] = None, order: Optional[int] = None,
            shuffle: bool = True, adaptive_sampling: bool = False,
            sampling_alpha: float = 1.0, prefetch: int = 1,
            crop_size: int = None):
        """Train on a dataset of ``(image, labels)`` pairs.

        The targets of the next ``prefetch`` batches are built in a host
        thread pool while the card runs the current step. The epoch order is
        shuffled from the trainer's seed (or, with ``adaptive_sampling``,
        drawn with weights from each item's loss); a last partial batch is
        filled with the epoch's first items. Every ``val_every`` epochs,
        ``val_data`` is validated (and the model calibrated,
        :meth:`validate`); with ``checkpoint_dir`` each epoch ends by writing
        ``last.ckpt``. Returns ``history``: per epoch the last loss and its
        moving average.

        With a mesh of several ranks every rank walks the same epoch order
        and builds its slice, ``batch_size // world`` items, of each batch
        from the same per-item seeds, so an item's crop and targets do not
        depend on the rank that builds it; ``batch_size`` must divide by the
        world size. The losses are the global batch's, the same on every
        rank.
        """
        samples = samples or self.model.samples
        order = order or self.model.order
        n = len(train_data)
        order_idx = np.arange(n)
        # the counter keeps repeated fit() calls from replaying one shuffle
        rng_np = np.random.RandomState((self.seed + 977 * self._np_seed_counter) % (2 ** 31))
        self._np_seed_counter += 1
        item_loss = np.zeros(n)
        item_seen = np.zeros(n, bool)
        prefetch = max(prefetch, 1)
        n_proc, rank = 1, 0
        if mesh_spans_processes(self.mesh):
            group = mesh_group(self.mesh)
            n_proc, rank = dist.get_world_size(group), dist.get_rank(group)
            if batch_size % n_proc:
                raise ValueError(f'multi-process fit: batch_size ({batch_size}) must be divisible '
                                 f'by the number of ranks ({n_proc})')
        lo, hi = rank * (batch_size // n_proc), (rank + 1) * (batch_size // n_proc)
        pool = ThreadPoolExecutor(max_workers=prefetch)
        try:
            for epoch in range(epochs):
                self.item_record = {}
                if adaptive_sampling and item_seen.all():
                    w = np.power(np.maximum(item_loss, 1e-8), sampling_alpha)
                    w = w / w.sum()
                    order_idx = rng_np.choice(n, size=n, replace=True, p=w)
                elif shuffle:
                    order_idx = np.arange(n)
                    rng_np.shuffle(order_idx)
                t0 = time.time()
                if n % batch_size:
                    pad = batch_size - n % batch_size
                    epoch_idx = np.concatenate([order_idx, order_idx[:pad]])
                else:
                    epoch_idx = order_idx
                starts = list(range(0, len(epoch_idx), batch_size))
                batch_rngs = [np.random.RandomState(rng_np.randint(2 ** 31)) for _ in starts]

                def submit(j):
                    gidx = epoch_idx[starts[j]:starts[j] + batch_size]
                    seeds = batch_rngs[j].randint(2 ** 31, size=len(gidx))
                    return pool.submit(self._make_batch, train_data, gidx[lo:hi], samples, order,
                                       max_instances, batch_rngs[j], crop_size, seeds[lo:hi])

                window = {j: submit(j) for j in range(min(prefetch, len(starts)))}
                for bi, start in enumerate(starts):
                    idx = epoch_idx[start:start + batch_size][lo:hi]
                    batch = window.pop(bi).result()
                    if bi + prefetch < len(starts):
                        window[bi + prefetch] = submit(bi + prefetch)
                    self.state, metrics = self._step_fn(self.state, batch, self.generator)
                    loss = float(metrics['loss'])
                    self._ema_loss = loss if self._ema_loss is None else \
                        self.ema_decay * self._ema_loss + (1 - self.ema_decay) * loss
                    for i in idx:
                        self.item_record.setdefault(int(i), []).append({'batch_loss': loss})
                for i, recs in self.gather_item_records().items():
                    if i >= n:
                        continue
                    mean_loss = float(np.mean([r['batch_loss'] for r in recs]))
                    item_loss[i] = mean_loss if not item_seen[i] else \
                        0.5 * item_loss[i] + 0.5 * mean_loss
                    item_seen[i] = True
                self.log_fn(f'epoch {epoch}: loss={loss:.4f} ema={self._ema_loss:.4f} '
                            f'({time.time() - t0:.1f}s)')
                self.history.append({'epoch': epoch, 'loss': loss, 'ema_loss': self._ema_loss})
                if val_data is not None and (epoch + 1) % val_every == 0:
                    self.validate(val_data)
                if self.checkpoint_dir:
                    self.save_checkpoint(os.path.join(self.checkpoint_dir, 'last.ckpt'))
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
            self.model.eval()
        return self.history

    def gather_item_records(self) -> Dict[int, list]:
        """The epoch's per-item loss records, merged over the ranks of the
        mesh (the reference's ``all_gather_object``): each rank's ``(item,
        loss)`` pairs, padded to the longest, go through one host all-gather."""
        record = getattr(self, 'item_record', {})
        if not mesh_spans_processes(self.mesh):
            return record
        group = host_group(mesh_group(self.mesh))
        world = dist.get_world_size(group)
        keys = torch.tensor([k for k, v in record.items() for _ in v], dtype=torch.int64)
        vals = torch.tensor([r['batch_loss'] for v in record.values() for r in v],
                            dtype=torch.float64)
        counts = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
        dist.all_gather(counts, torch.tensor([len(keys)]), group=group)
        m = int(max(c.item() for c in counts))
        pad = m - len(keys)
        keys = torch.cat([keys, torch.full((pad,), -1, dtype=torch.int64)])
        vals = torch.cat([vals, torch.zeros(pad, dtype=torch.float64)])
        keys_all = [torch.empty_like(keys) for _ in range(world)]
        vals_all = [torch.empty_like(vals) for _ in range(world)]
        dist.all_gather(keys_all, keys, group=group)
        dist.all_gather(vals_all, vals, group=group)
        merged: Dict[int, list] = {}
        for k, v in zip(torch.cat(keys_all).tolist(), torch.cat(vals_all).tolist()):
            if k >= 0:
                merged.setdefault(int(k), []).append({'batch_loss': float(v)})
        return merged

    # --- prediction ---------------------------------------------------------

    def _apply_model_hparams(self, hparams: dict) -> dict:
        """Set model attributes (``nms_thresh``, ...) and return their
        previous values; the cached tiled runner is dropped when one changes."""
        saved, changed = {}, False
        for k, v in hparams.items():
            if not hasattr(self.model, k):
                raise AttributeError(f'Unknown model hparam for prediction: {k!r}')
            cur = getattr(self.model, k)
            saved[k] = cur
            if cur != v:
                setattr(self.model, k, v)
                changed = True
        if changed:
            self._tiled = None
        return saved

    def _predict_single(self, image: np.ndarray, **hparams) -> dict:
        score_thresh = hparams.pop('score_thresh', None)
        saved = self._apply_model_hparams(hparams) if hparams else {}
        try:
            if max(image.shape[:2]) > self.max_imsize:
                if self._tiled is None:
                    from ..parallel.tiles import TiledInference
                    self._tiled = TiledInference(self.model, tile_size=self.tile_size,
                                                 stride=self.tile_stride)
                return self._tiled(image, score_thresh=score_thresh)
            out = self.model(image, score_thresh=score_thresh)
            return {k: (v[0] if isinstance(v, list) else v) for k, v in out.items()}
        finally:
            if saved:
                self._apply_model_hparams(saved)

    def predict(self, images) -> List[dict]:
        """Predict on one or more images (tiled when larger than ``max_imsize``)."""
        self.model.eval()
        if isinstance(images, np.ndarray) and images.ndim <= 3:
            images = [images]
        return [self._predict_single(np.asarray(im, np.float32)) for im in images]

    # --- validation sweep and calibration -----------------------------------

    def validate(self, val_data, iou_threshs: Sequence[float] = (.5, .6, .7, .8, .9),
                 calibrate: bool = True, reduce_fn=None, fast_labels: bool = False,
                 distributed: bool = False) -> Dict[str, float]:
        """Validation over the ``val_hparams`` sweep, with self-calibration.

        For every combination of ``val_hparams`` values, each item of
        ``val_data`` (``(image, labels)`` or ``(image, labels, classes)``)
        is predicted (tiled above ``max_imsize``), its contours rendered to a
        label image (:func:`..data.cpn.contours2labels`, whose channels keep
        overlaps; with ``fast_labels`` the native flat fill of
        :func:`..native.contours2labels_native`) and matched against its
        labels (:class:`..data.instance_eval.LabelMatcher`). The metrics are
        reduced over ``iou_threshs``; ``reduce_fn`` sums the counts over
        processes. With ``calibrate`` the best setting by ``f1_np`` is set on
        the model. Returns the best setting's metrics with ``best_hparams``.

        ``distributed=True`` (every rank calls it with the same data) gives
        each rank the items ``i % world == rank`` and sums the counts over
        the ranks with :func:`..parallel.mesh.host_all_reduce_sum`, so every
        rank gets the metrics and ``best_hparams`` of the whole set;
        ``val_results`` keeps this rank's items' counts.
        """
        if distributed:
            group = mesh_group(self.mesh)
            val_data = shard_inputs_by_process(list(val_data), 'rank')
            reduce_fn = reduce_fn or (lambda v: host_all_reduce_sum(v, group))
        self.model.eval()
        keys = list(self.val_hparams.keys())
        results, self.val_results = {}, []
        seconds = {'forward': 0., 'labels': 0., 'matching': 0.}
        for combo in product(*self.val_hparams.values()):
            setting = dict(zip(keys, combo))
            combo_saved = self._apply_model_hparams(
                {k: v for k, v in setting.items() if k != 'score_thresh'})
            matchers = LabelMatcherList(reduce_fn=reduce_fn)
            for item in val_data:
                image, labels = item[0], item[1]
                if image.ndim == 2:
                    image = image[..., None]
                t0 = time.perf_counter()
                pred = self._predict_single(np.asarray(image, np.float32),
                                            score_thresh=setting.get('score_thresh'))
                t1 = time.perf_counter()
                h, w = image.shape[:2]
                if fast_labels:
                    from ..native import contours2labels_native
                    pred_labels = contours2labels_native(list(pred['contours']), (h, w))
                else:
                    pred_labels = contours2labels(list(pred['contours']), (h, w))
                t2 = time.perf_counter()
                matchers.append(LabelMatcher(pred_labels, labels))
                seconds['forward'] += t1 - t0
                seconds['labels'] += t2 - t1
                seconds['matching'] += time.perf_counter() - t2
            t0 = time.perf_counter()
            metrics, counts = {}, []
            for it in iou_threshs:
                matchers.iou_thresh = it
                metrics[f'f1_np_{it}'] = matchers.f1_np
                metrics[f'avg_f1_{it}'] = matchers.avg_f1
                metrics[f'jaccard_np_{it}'] = matchers.jaccard_np
                counts.append([(m.true_positives, m.false_positives, m.false_negatives)
                               for m in matchers])
            metrics['f1_np'] = float(np.mean([metrics[f'f1_np_{t}'] for t in iou_threshs]))
            metrics['avg_f1'] = float(np.mean([metrics[f'avg_f1_{t}'] for t in iou_threshs]))
            seconds['matching'] += time.perf_counter() - t0
            results[combo] = metrics
            # counts [image, IoU threshold, (TP, FP, FN)]
            self.val_results.append({'setting': setting, 'metrics': metrics,
                                     'counts': np.array(counts).reshape(len(iou_threshs), -1, 3)
                                     .transpose(1, 0, 2)})
            self.log_fn(f'val {setting}: f1_np={metrics["f1_np"]:.4f}')
            self._apply_model_hparams(combo_saved)
        self.val_seconds = seconds
        best_combo = max(results, key=lambda c: results[c]['f1_np'])
        # plain python numbers: best_hparams lands in msgpack checkpoints
        self.best_hparams = {k: (v.item() if isinstance(v, np.generic) else v)
                             for k, v in zip(keys, best_combo)}
        if calibrate:
            for k, v in self.best_hparams.items():
                setattr(self.model, k, v)
            self._tiled = None
            self.log_fn(f'calibrated: {self.best_hparams} '
                        f'(f1_np={results[best_combo]["f1_np"]:.4f})')
        out = dict(results[best_combo])
        out['best_hparams'] = self.best_hparams
        return out

    # --- checkpointing ------------------------------------------------------

    def save_checkpoint(self, path: str, backend: str = 'msgpack'):
        """Save the weights, the optimizer, the step, the random state and
        ``best_hparams`` to one msgpack file.

        ``variables`` is flax's encoding of the JAX-layout tree, so the JAX
        package reads the weights (``flax.serialization.msgpack_restore``);
        ``opt_state`` holds the optimizer's and the schedule's state dicts,
        ``rng`` the state of the steps' ``torch.Generator`` and the count of
        ``fit`` calls that seeds the host pipeline.

        With a mesh of several ranks (every rank calls it), rank 0 writes the
        file and the others wait for it at a barrier: the file is the one a
        single process writes (rank 0's generator state).
        """
        if backend == 'orbax':
            raise NotImplementedError('Orbax is the JAX package\'s checkpointer; the port '
                                      'writes msgpack checkpoints (backend="msgpack")')
        encoder, fused = body_layout(self.model)
        sched = self.state.scheduler
        payload = {
            'variables': msgpack_serialize(
                jax_variables_from_state_dict(self.model.state_dict(), fused, encoder)),
            'opt_state': packb(_numpy_tree({
                'optimizer': self.state.optimizer.state_dict(),
                'scheduler': None if sched is None else sched.state_dict()})),
            'step': self.state.step,
            'rng': {'generator': self.generator.get_state().numpy(),
                    'np_seed_counter': self._np_seed_counter},
            'best_hparams': self.best_hparams,
        }
        multi = mesh_spans_processes(self.mesh)
        if not multi or dist.get_rank(mesh_group(self.mesh)) == 0:
            os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
            with open(path, 'wb') as f:
                f.write(packb(payload))
        if multi:
            dist.barrier(group=host_group(mesh_group(self.mesh)))

    def load_checkpoint(self, path: str, backend: str = 'msgpack'):
        """Restore what :meth:`save_checkpoint` wrote into this trainer."""
        if backend == 'orbax':
            raise NotImplementedError('Orbax is the JAX package\'s checkpointer; the port '
                                      'reads msgpack checkpoints (backend="msgpack")')
        with open(path, 'rb') as f:
            payload = unpackb(f.read())
        _, fused = body_layout(self.model)
        self.model.load_state_dict(state_dict_from_jax(msgpack_restore(payload['variables']),
                                                       fused), strict=True)
        opt = _torch_tree(unpackb(payload['opt_state']))
        self.state.optimizer.load_state_dict(opt['optimizer'])
        if self.state.scheduler is not None and opt['scheduler'] is not None:
            self.state.scheduler.load_state_dict(opt['scheduler'])
        self.state.step = payload['step']
        self.generator.set_state(torch.from_numpy(np.array(payload['rng']['generator'])))
        self._np_seed_counter = payload['rng']['np_seed_counter']
        self.best_hparams = payload.get('best_hparams', {})
