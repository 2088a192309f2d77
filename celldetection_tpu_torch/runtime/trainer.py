"""CPN training and prediction on one card.

Counterpart of ``celldetection_tpu/runtime/trainer.py``: ``CPNTrainer`` with
``__init__`` (49-85), ``_make_batch`` (89-122), ``fit`` (124-253),
``gather_item_records`` (255-278) and ``predict`` (379-401). Validation with
its hyperparameter sweep, checkpoints, the metrics logger, figure logging
and a device mesh belong to later slices of the port and raise here.
"""
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.misc import random_crop, random_pad
from ..data.targets import collate_cpn_targets, cpn_targets_single
from ..parallel.train import DDP_SLICE, TrainState, make_train_step
from ..util.config import conf2optimizer

__all__ = ['CPNTrainer']

VALIDATE_SLICE = ('validation (the hyperparameter sweep with instance matching, '
                  'data/instance_eval.py) is not ported yet; it comes with the validate slice')
CHECKPOINT_SLICE = ('checkpoints are not ported yet; they come with the slice of checkpoint '
                    'I/O and the command-line interface')


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
        max_imsize: :meth:`predict` tiles inputs larger than this.
        ema_decay: Decay of the loss's moving average.
        seed: Seeds the host pipeline (shuffles, per-item seeds) and the
            ``torch.Generator`` of the training steps' random draws.
    """

    def __init__(self, model, optimizer=None, scheduler: Optional[Callable[[int], float]] = None,
                 val_hparams: Optional[Dict[str, Sequence]] = None, mesh=None,
                 checkpoint_dir: Optional[str] = None, max_imsize: int = 2048,
                 tile_size: int = 1024, tile_stride: int = 512, ema_decay: float = 0.99,
                 log_fn: Callable = print, seed: int = 0, metrics_logger=None,
                 log_figures_every: int = 0):
        if mesh is not None:
            raise NotImplementedError(DDP_SLICE)
        if val_hparams is not None:
            raise NotImplementedError(VALIDATE_SLICE)
        if checkpoint_dir is not None:
            raise NotImplementedError(CHECKPOINT_SLICE)
        if metrics_logger is not None or log_figures_every:
            raise NotImplementedError('the metrics logger and figure logging are not ported '
                                      'yet; they come with the slice of checkpoint I/O and '
                                      'the command-line interface')
        self.model = model
        if optimizer is None:
            optimizer = conf2optimizer({'Adam': {'lr': 1e-3}})
        elif isinstance(optimizer, dict):
            optimizer = conf2optimizer(optimizer)
        self.state = TrainState.create(model, optimizer, scheduler)
        self._step_fn = make_train_step(model, self.state.optimizer,
                                        scheduler=self.state.scheduler)
        self.max_imsize = max_imsize
        self.tile_size = tile_size
        self.tile_stride = tile_stride
        self.ema_decay = ema_decay
        self.log_fn = log_fn
        self.seed = seed
        self.generator = torch.Generator(device=model.device).manual_seed(seed)
        self._np_seed_counter = 0
        self._ema_loss = None
        self._tiled = None
        self.history: List[dict] = []

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
        filled with the epoch's first items. Returns ``history``: per epoch
        the last loss and its moving average.
        """
        if val_data is not None:
            raise NotImplementedError(VALIDATE_SLICE)
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
                    return pool.submit(self._make_batch, train_data, gidx, samples, order,
                                       max_instances, batch_rngs[j], crop_size, seeds)

                window = {j: submit(j) for j in range(min(prefetch, len(starts)))}
                for bi, start in enumerate(starts):
                    idx = epoch_idx[start:start + batch_size]
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
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
            self.model.eval()
        return self.history

    def gather_item_records(self) -> Dict[int, list]:
        """The epoch's per-item loss records (one process: this one's)."""
        return getattr(self, 'item_record', {})

    def validate(self, val_data, *args, **kwargs):
        raise NotImplementedError(VALIDATE_SLICE)

    def save_checkpoint(self, path: str, *args, **kwargs):
        raise NotImplementedError(CHECKPOINT_SLICE)

    def load_checkpoint(self, path: str, *args, **kwargs):
        raise NotImplementedError(CHECKPOINT_SLICE)

    # --- prediction ---------------------------------------------------------

    def _predict_single(self, image: np.ndarray, score_thresh=None) -> dict:
        if max(image.shape[:2]) > self.max_imsize:
            if self._tiled is None:
                from ..parallel.tiles import TiledInference
                self._tiled = TiledInference(self.model, tile_size=self.tile_size,
                                             stride=self.tile_stride)
            return self._tiled(image, score_thresh=score_thresh)
        out = self.model(image, score_thresh=score_thresh)
        return {k: (v[0] if isinstance(v, list) else v) for k, v in out.items()}

    def predict(self, images) -> List[dict]:
        """Predict on one or more images (tiled when larger than ``max_imsize``)."""
        self.model.eval()
        if isinstance(images, np.ndarray) and images.ndim <= 3:
            images = [images]
        return [self._predict_single(np.asarray(im, np.float32)) for im in images]
