"""Port parity: CPN training (loss, gradients, norm statistics, optimizers,
schedules, ``CPNTrainer.fit``).

The same numpy-seeded weights, images and targets go through the JAX
package on the CPU and through ``celldetection_tpu_torch`` with
``device='cpu'``, at a small size (CpnU22 at base 8, 64^2 inputs, batch 2):

* one training forward, JAX's ``forward_padded(train=True, targets=...,
  mutable=True)`` under ``jax.value_and_grad`` against the port's
  ``forward_padded`` in train mode and ``backward``: the loss and each term
  within 1e-5 relative, each parameter's gradient within 1e-4 of its
  tensor's largest absolute gradient, the norms' running statistics within
  1e-6 of each tensor's largest value (at least 1e-6: the Fourier head's
  fused 7x7 convolution sums in another order, which moves its batch
  variance by about 1e-6 relative), every port gradient finite. A conv bias that feeds a batch norm has
  a gradient of 0 but for rounding (the norm subtracts the batch mean); it is
  held within 1e-4 of its conv weight's largest absolute gradient instead.
  The capacity K is the score map's pixel count, so every foreground pixel
  is selected whatever the (framework's own) random priority; the losses are masked means and do not depend on the
  order. Both sides apply the same dropout masks, drawn with numpy
  (flax's draw cannot be reproduced);
* every optimizer name of ``conf2optimizer`` against the JAX package's optax
  transformation over 3 steps of identical gradients: parameters within 1e-6;
* the schedules and ``ReduceLROnPlateau`` against the JAX functions;
* ``CPNTrainer.fit`` on 4 tiny images for 2 epochs (4 steps of Adam at
  1e-3): the same epoch order and item seeds as the JAX trainer, the first
  step's loss within 1e-5 relative and the later ones within 1e-2. Training
  from random weights parts two runs quickly: the refinement rounds contour
  points to pixels and the IoU loss masks boxes by size, so the loss is not
  smooth. The JAX package against itself, with every weight moved by one
  ulp, parts by up to 9e-3 in these 4 steps; the port against JAX by 1e-3.
"""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from celldetection_tpu import data as jdata
from celldetection_tpu import models as jmodels
from celldetection_tpu import optim as joptim
from celldetection_tpu.runtime.trainer import CPNTrainer as JTrainer
from celldetection_tpu.util import config as jconfig
from celldetection_tpu_torch import data as tdata
from celldetection_tpu_torch import models as tmodels
from celldetection_tpu_torch import optim as toptim
from celldetection_tpu_torch.models.commons import Dropout2d
from celldetection_tpu_torch.parallel.train import TrainState, make_train_step
from celldetection_tpu_torch.runtime.trainer import CPNTrainer as TTrainer
from celldetection_tpu_torch.util import config as tconfig
from celldetection_tpu_torch.util import init_jax_variables, state_dict_from_jax
from test_torch_port_cpn import one_torch_thread  # noqa: F401  (pytestmark)

pytestmark = pytest.mark.usefixtures('one_torch_thread')

SIZE, BATCH, SAMPLES, BASE = 64, 2, 16, 8
K = SIZE * SIZE            # at least the score map's pixels: every fg pixel is selected


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in dict(tree).items()}


def _dataset(n, seed=0, size=SIZE, num=5):
    out = []
    for i in range(n):
        img, labels = jdata.random_geometric_objects(size, size, num=num, radius=(5, 12),
                                                     seed=seed + i)
        out.append((img.astype(np.float32)[..., None], labels))
    return out


def _models(seed=0, **kw):
    kw = dict(in_channels=1, backbone_kwargs=dict(base_channels=BASE), max_detections=K,
              samples=SAMPLES, **kw)
    pm = tmodels.CpnU22(device='cpu', **kw)
    variables = init_jax_variables(pm, seed)
    pm.load_state_dict(state_dict_from_jax(variables), strict=True)
    jm = jmodels.CpnU22(**kw)
    jm.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    return pm, jm, variables


def _batch(seed=0):
    items = _dataset(BATCH, seed)
    targets = [tdata.cpn_targets_single(lab.copy(), SAMPLES, 5, rng=np.random.RandomState(i))
               for i, (_, lab) in enumerate(items)]
    t = tdata.collate_cpn_targets(targets, max_instances=16)
    t.pop('num_instances')
    return np.stack([im for im, _ in items]), t


class _SharedDropout:
    """The same numpy-drawn channel masks for flax's ``Dropout`` and the port's
    ``Dropout2d``, keyed by head."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)
        self.masks = {}

    def mask(self, head, batch, channels, rate):
        if head not in self.masks:
            self.masks[head] = self.rng.rand(batch, channels) >= rate
        return self.masks[head]

    def jax_interceptor(self, call, args, kwargs, context):
        mod = context.module
        if not isinstance(mod, flax.linen.Dropout):
            return call(*args, **kwargs)
        x = args[0]
        keep = 1. - mod.rate
        m = self.mask(mod.path[0], x.shape[0], x.shape[-1], mod.rate)[:, None, None, :]
        return jnp.where(jnp.asarray(m), x / keep, 0.)

    def hook_port(self, model):
        for name, mod in model.named_modules():
            if type(mod) is Dropout2d:   # not stochastic depth, which flax draws otherwise
                head = name.split('.')[1]

                def hook(m, inputs, output, head=head):
                    x = inputs[0]
                    mask = self.mask(head, x.shape[0], x.shape[1], m.p)
                    return torch.where(torch.from_numpy(mask)[:, :, None, None], x / (1 - m.p), 0.)
                mod.register_forward_hook(hook)


def _jax_train_forward(jm, variables, x, targets, dropout):
    params = variables['params']
    state = {k: v for k, v in variables.items() if k != 'params'}
    tj = {k: jnp.asarray(v) for k, v in targets.items()}

    def loss_fn(p):
        with flax.linen.intercept_methods(dropout.jax_interceptor):
            out, new_state = jm.forward_padded({'params': p, **state}, jnp.asarray(x),
                                               train=True, targets=tj,
                                               selection_rng=jax.random.PRNGKey(0), mutable=True)
        return out['loss'], (out['losses'], new_state)

    (loss, (losses, new_state)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return float(loss), {k: float(v) for k, v in losses.items()}, _numpy_tree(grads), \
        _numpy_tree(new_state)


@pytest.fixture(scope='module')
def train_forward_pair():
    pm, jm, variables = _models(seed=3)
    x, targets = _batch(seed=10)
    dropout = _SharedDropout(7)
    j_loss, j_losses, j_grads, j_state = _jax_train_forward(jm, variables, x, targets, dropout)
    dropout.hook_port(pm)
    pm.train()
    out = pm.forward_padded(torch.from_numpy(x),
                            targets={k: torch.from_numpy(v) for k, v in targets.items()},
                            generator=torch.Generator().manual_seed(0))
    out['loss'].backward()
    return dict(pm=pm, out=out, j_loss=j_loss, j_losses=j_losses, j_grads=j_grads,
                j_state=j_state, targets=targets)


def _float64(tree):
    return {k: _float64(v) if isinstance(v, dict) else
            (np.asarray(v, np.float64) if np.asarray(v).dtype == np.float32 else v)
            for k, v in tree.items()}


@pytest.fixture(scope='module')
def train_forward_pair64():
    """The training forward of ``train_forward_pair`` in float64 on both
    sides: JAX with x64 enabled for this fixture alone, the port's model,
    input and float targets cast to float64."""
    pm, jm, variables = _models(seed=3)
    x, targets = _batch(seed=10)
    x, targets, variables = x.astype(np.float64), _float64(targets), _float64(variables)
    dropout = _SharedDropout(7)
    with jax.enable_x64(True):
        jm.variables = jax.tree_util.tree_map(jnp.asarray, variables)
        j_loss, _, j_grads, _ = _jax_train_forward(jm, variables, x, targets, dropout)
    assert all(g.dtype == np.float64 for g in jax.tree_util.tree_leaves(j_grads))
    dropout.hook_port(pm)
    pm.double().train()
    out = pm.forward_padded(torch.from_numpy(x),
                            targets={k: torch.from_numpy(v) for k, v in targets.items()},
                            generator=torch.Generator().manual_seed(0))
    out['loss'].backward()
    return dict(pm=pm, out=out, j_loss=j_loss, j_grads=j_grads)


def test_train_forward_loss_matches_jax(train_forward_pair):
    r = train_forward_pair
    out = r['out']
    assert set(out['losses']) == set(r['j_losses']) == {'score', 'fourier', 'location', 'contour',
                                                        'refinement', 'iou'}
    np.testing.assert_allclose(out['loss'].item(), r['j_loss'], rtol=1e-5)
    for k, v in r['j_losses'].items():
        np.testing.assert_allclose(out['losses'][k].item(), v, rtol=1e-5, err_msg=k)
    # every foreground pixel of the score map was selected on both sides
    fg = int((out['dense_labels'] > 0).sum())
    assert int(out['valid'].sum()) == fg > 0


def _biases_before_norms(model):
    """Keys of conv biases that feed a batch norm: in train mode the norm
    subtracts the batch mean, so their gradient is 0 but for rounding."""
    keys = set()
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.Sequential):
            for i in range(len(mod) - 1):
                if isinstance(mod[i], torch.nn.Conv2d) and isinstance(mod[i + 1], tmodels.Norm):
                    keys.add(f'{name}.{i}.bias')
    return keys


def test_train_forward_gradients_match_jax(train_forward_pair64):
    """In float64: float32 rounding of this net exceeds 1e-4 of a tensor's
    largest gradient on some machines (the stem norm's weight by up to
    4.5e-4), while in float64 the two sides agree to some 1e-13."""
    r = train_forward_pair64
    np.testing.assert_allclose(r['out']['loss'].item(), r['j_loss'], rtol=1e-12)
    want = state_dict_from_jax({'params': r['j_grads']})
    got = {k: p.grad for k, p in r['pm'].named_parameters()}
    assert sorted(got) == sorted(want)
    zero = _biases_before_norms(r['pm'])
    assert len(zero) == 22   # 2 in each of the 9 U-Net blocks, 1 in each head
    for key, g in got.items():
        assert g is not None and g.dtype == torch.float64 and torch.isfinite(g).all(), key
        ref = want[key].numpy()
        # a bias before a norm is held against its conv weight's gradient scale
        scale_key = key[:-len('bias')] + 'weight' if key in zero else key
        atol = 1e-9 * float(np.abs(want[scale_key].numpy()).max())
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=atol, err_msg=key)


def test_train_forward_running_statistics_match_jax(train_forward_pair):
    r = train_forward_pair
    want = state_dict_from_jax(r['j_state'])
    buffers = dict(r['pm'].named_buffers())
    assert want and set(want) <= set(buffers)
    for key, ref in want.items():
        ref = ref.numpy()
        atol = 1e-6 * max(1., float(np.abs(ref).max()))
        np.testing.assert_allclose(buffers[key].numpy(), ref, rtol=0, atol=atol, err_msg=key)


def test_norm_updates_running_statistics_with_the_biased_variance():
    norm = tmodels.Norm(3).train()
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 3, 2, 2).astype(np.float32) * 3 + 1)
    y = norm(x)
    var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    torch.testing.assert_close(norm.running_mean, 0.1 * mean, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(norm.running_var, 0.9 + 0.1 * var, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(y.mean((0, 2, 3)), torch.zeros(3), rtol=0, atol=1e-5)
    norm.eval()   # inference normalises with the running statistics
    torch.testing.assert_close(norm(x), (x - norm.running_mean[:, None, None])
                               / torch.sqrt(norm.running_var[:, None, None] + 1e-5))


def test_train_step_keeps_gradients_finite_and_updates():
    """make_train_step: one Adam step changes the weights, the metrics are the
    forward's loss terms, and a mesh needs a process group."""
    pm, _, _ = _models(seed=1)
    x, targets = _batch(seed=20)
    state = TrainState.create(pm, tconfig.conf2optimizer({'Adam': {'lr': 1e-3}}))
    step = make_train_step(pm, state.optimizer)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    state, metrics = step(state, {'image': x, **targets}, torch.Generator().manual_seed(0))
    assert state.step == 1 and np.isfinite(float(metrics['loss']))
    assert {'loss_score', 'loss_fourier', 'loss_iou'} <= set(metrics)
    changed = [k for k, v in pm.state_dict().items() if not torch.equal(v, before[k])]
    assert len(changed) == len(before)   # every parameter and running statistic moved
    with pytest.raises(RuntimeError, match='process group'):
        make_train_step(pm, state.optimizer, mesh=object())


# -- optimizers and schedules -------------------------------------------------

OPTIMIZERS = [
    {'Adam': {'lr': 1e-2}},
    {'Adam': {'lr': 1e-2, 'weight_decay': 0.1}},
    {'AdamW': {'lr': 1e-2, 'weight_decay': 0.05}},
    {'SGD': {'lr': 0.1}},
    {'SGD': {'lr': 0.1, 'momentum': 0.9, 'weight_decay': 0.01}},
    {'SGD': {'lr': 0.1, 'momentum': 0.9, 'nesterov': True}},
    {'RMSprop': {'lr': 1e-2}},
    {'RMSprop': {'lr': 1e-2, 'momentum': 0.5, 'eps': 1e-3}},
    {'Adamax': {'lr': 1e-2}},
    {'Adadelta': {'lr': 1.}},
    {'Adadelta': {'lr': 0.5, 'weight_decay': 0.1}},
    {'Adagrad': {'lr': 0.1}},
    {'Adagrad': {'lr': 0.1, 'initial_accumulator_value': 0.5, 'eps': 1e-3}},
]


@pytest.mark.parametrize('conf', OPTIMIZERS, ids=lambda c: '-'.join(
    [next(iter(c))] + [f'{k}={v}' for k, v in next(iter(c.values())).items()]))
def test_optimizer_matches_optax(conf):
    rng = np.random.RandomState(0)
    p0 = rng.randn(5, 4).astype(np.float32)
    grads = [rng.randn(5, 4).astype(np.float32) for _ in range(3)]
    grads[1][0] = 0.   # a zero gradient row (Adagrad's where, RMSprop's sqrt(eps))
    tx = jconfig.conf2optimizer(conf)
    pj = jnp.asarray(p0)
    sj = tx.init(pj)
    pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = tconfig.conf2optimizer(conf)([pt])
    for g in grads:
        upd, sj = tx.update(jnp.asarray(g), sj, pj)
        pj = optax.apply_updates(pj, upd)
        pt.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), rtol=0, atol=1e-6)


def test_optimizer_registry_edges():
    with pytest.raises(ValueError, match='lr_decay'):
        tconfig.conf2optimizer({'Adagrad': {'lr_decay': 0.1}})
    with pytest.raises(KeyError):
        tconfig.conf2optimizer({'Lion': {}})
    # optax's eps sits inside the square root, torch.optim's outside
    p = torch.nn.Parameter(torch.ones(1))
    p.grad = torch.zeros(1) + 1e-4
    toptim.RMSprop([p], lr=1., eps=1e-2).step()
    np.testing.assert_allclose(p.item(), 1 - 1e-4 / np.sqrt(0.01 * 1e-8 + 1e-2), rtol=1e-6)


SCHEDULES = [
    {'StepLR': {'step_size': 3, 'gamma': 0.5}},
    {'ExponentialLR': {'gamma': 0.9, 'base': 2.}},
    {'CosineAnnealingLR': {'T_max': 7, 'eta_min': 0.1}},
    {'WarmupCosine': {'warmup_steps': 3, 'total_steps': 10, 'eta_min': 0.05}},
]


@pytest.mark.parametrize('conf', SCHEDULES, ids=lambda c: next(iter(c)))
def test_scheduler_matches_jax(conf):
    fj, ft = jconfig.conf2scheduler(conf), tconfig.conf2scheduler(conf)
    for step in range(14):
        np.testing.assert_allclose(ft(step), float(fj(step)), rtol=1e-6, err_msg=str(step))


def test_warmup_and_sequential_schedules_match_jax():
    for steps, base in ((4, 1.), (1, 2.), (0, 1.)):
        fj, ft = joptim.warmup_schedule(steps, base), toptim.warmup_schedule(steps, base)
        for s in range(8):
            np.testing.assert_allclose(ft(s), float(fj(s)), rtol=1e-6)
    parts_j = [joptim.warmup_schedule(3), lambda s: 0.5 + 0 * s, joptim.warmup_schedule(2, 0.1)]
    parts_t = [toptim.warmup_schedule(3), lambda s: 0.5, toptim.warmup_schedule(2, 0.1)]
    fj = joptim.sequential_schedule(parts_j, [3, 6])
    ft = toptim.sequential_schedule(parts_t, [3, 6])
    for s in range(10):
        np.testing.assert_allclose(ft(s), float(fj(s)), rtol=1e-6, err_msg=str(s))
    for s in (0, 10, 999, 1000, 5000):
        assert toptim.get_warmup_factor(s, 1000) == joptim.get_warmup_factor(s, 1000)
    assert toptim.get_warmup_factor(5, 10, method='constant') == 0.001
    for f in ('sqrt', 'linear', 0.5):
        assert toptim.scaled_lr(0.1, 4, f) == joptim.scaled_lr(0.1, 4, f)


def test_reduce_lr_on_plateau_matches_jax():
    metrics = [1., .9, .95, .96, .97, .8, .81, .82, .83, .84, .85, .86]
    for kw in (dict(patience=2, factor=0.5), dict(patience=1, mode='max', warmup_grace=2),
               dict(patience=0, factor=0.1, min_lr_factor=0.05)):
        cj, ct_ = joptim.ReduceLROnPlateau(**kw), toptim.ReduceLROnPlateau(**kw)
        assert [ct_.step(m) for m in metrics] == [cj.step(m) for m in metrics]


def test_trainer_step_uses_the_schedule_from_step_zero():
    pm, _, _ = _models(seed=2)
    seen = []
    tr = TTrainer(pm, optimizer={'SGD': {'lr': 0.5}},
                  scheduler=lambda s: seen.append(s) or 0.1 * (s + 1), log_fn=lambda *a: None)
    assert tr.state.optimizer.param_groups[0]['lr'] == pytest.approx(0.05)   # step 0
    tr.fit(_dataset(2, seed=40), epochs=1, batch_size=2, max_instances=16)
    assert tr.state.optimizer.param_groups[0]['lr'] == pytest.approx(0.1)    # step 1 next
    assert seen[:2] == [0, 1]


# -- CPNTrainer.fit ------------------------------------------------------------

def test_fit_matches_jax_trainer():
    """Same seed: the same epoch order and item seeds, and losses that track."""
    data = _dataset(4, seed=30)
    pm, jm, variables = _models(seed=4)
    # dropout off on both sides: its draws cannot be shared through fit
    for m in pm.modules():
        if isinstance(m, Dropout2d):
            m.p = 0.

    def no_dropout(call, args, kwargs, context):
        if isinstance(context.module, flax.linen.Dropout):
            return args[0]
        return call(*args, **kwargs)

    calls = {'jax': [], 'port': []}

    def spy(trainer, key):
        make = trainer._make_batch

        def wrapped(train_data, idx, *args):
            calls[key].append((list(map(int, idx)), list(map(int, args[-1]))))
            return make(train_data, idx, *args)
        trainer._make_batch = wrapped

    jt = JTrainer(jm, optimizer=optax.adam(1e-3), log_fn=lambda *a: None, seed=5)
    tt = TTrainer(pm, optimizer={'Adam': {'lr': 1e-3}}, log_fn=lambda *a: None, seed=5)
    spy(jt, 'jax')
    spy(tt, 'port')
    losses = {'jax': [], 'port': []}
    for key, tr in (('jax', jt), ('port', tt)):
        step = tr._step_fn

        def record(state, batch, rng, step=step, key=key):
            state, metrics = step(state, batch, rng)
            losses[key].append(float(metrics['loss']))
            return state, metrics
        tr._step_fn = record
    with flax.linen.intercept_methods(no_dropout):
        hj = jt.fit(data, epochs=2, batch_size=3, max_instances=16, samples=SAMPLES,
                    prefetch=2)
    ht = tt.fit(data, epochs=2, batch_size=3, max_instances=16, samples=SAMPLES, prefetch=2)
    assert calls['port'] == calls['jax'] and len(calls['port']) == 4   # wrap-padded batches
    assert len(losses['port']) == len(losses['jax']) == 4
    np.testing.assert_allclose(losses['port'][0], losses['jax'][0], rtol=1e-5)
    np.testing.assert_allclose(losses['port'][1:], losses['jax'][1:], rtol=1e-2)
    assert [h['epoch'] for h in ht] == [h['epoch'] for h in hj] == [0, 1]
    np.testing.assert_allclose([h['ema_loss'] for h in ht], [h['ema_loss'] for h in hj],
                               rtol=1e-2)
    assert not pm.training      # fit leaves the model in inference mode
    pred = tt.predict(data[0][0])
    assert pred[0]['contours'].shape[1:] == (SAMPLES, 2)


def test_fit_adaptive_sampling_and_unported_options():
    data = _dataset(3, seed=50)
    pm, _, _ = _models(seed=5)
    tr = TTrainer(pm, log_fn=lambda *a: None, seed=1)
    hist = tr.fit(data, epochs=3, batch_size=2, max_instances=16, adaptive_sampling=True)
    assert len(hist) == 3 and all(np.isfinite(h['loss']) for h in hist)
    assert set(tr.gather_item_records()) <= {0, 1, 2}
    with pytest.raises(RuntimeError, match='process group'):
        TTrainer(pm, mesh=object())
    with pytest.raises(NotImplementedError):
        TTrainer(pm, log_figures_every=5)
