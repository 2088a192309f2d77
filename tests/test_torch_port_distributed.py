"""Port parity: data-parallel training over two processes (``torch.distributed``).

Two real processes (``gloo`` on the CPU, one torch thread each, started
fresh as ``spawn`` starts them) run the port's multi-process training paths
once, at a small size (CpnU12 at base 8, 64^2, a global batch of 8: 4 per
rank), and the tests hold what they computed against one process on the
union batch, as ``tests/test_multihost_train.py`` does for the JAX package:

* the cross-process ``Norm`` (``models/commons.py: _GlobalBatchNorm``) in
  float64: outputs, input, weight and bias gradients and the running
  statistics within 1e-12 relative of one process's norm on the union batch;
* every loss term's global value (``ops/loss.py: global_means``) in float64
  within 1e-12 relative of one process's, for an even split and for a split
  where one rank has no instance;
* ``make_train_step(mesh=)``, three Adam steps at 1e-3: parameters
  bit-identical across the ranks after every step; the losses within
  ``rtol=1e-3`` (``test_multihost_train.py``'s gate) of the JAX package's
  single-process steps on the union batch, and of the port's (its first
  step within 1e-6: float32 rounding of sums in another order, which the
  loss's refinement rounding then amplifies, 1.8e-4 by the second step).
  K is the score map's pixel count, so every foreground pixel is selected
  whatever the random priority, and both sides apply the same numpy dropout
  masks (row ``i`` of the union batch gets mask row ``i`` on every side);
* ``CPNTrainer(mesh=).fit`` (2 epochs, dropout off): ranks bit-identical,
  the history within 1e-4 of the port's single-process ``fit``; its
  checkpoint written once, by rank 0, and equal to what one process writes
  of the same state;
* ``gather_item_records`` as ``test_multihost.py`` checks it, ``all_filter``,
  ``host_all_reduce_sum``, ``broadcast_from_rank0`` and
  ``shard_inputs_by_process`` over two ranks;
* in this process: ``initialize_distributed``'s reading of Slurm's and
  torchrun's environment, the task farm (``tests/test_tasks.py``'s case on
  the port's copy), ``KeepAlive`` and ``StepDropout``.
"""
import os
import pickle
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from test_torch_port_cpn import one_torch_thread  # noqa: F401  (pytestmark)

pytestmark = pytest.mark.usefixtures('one_torch_thread')

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# shared by this module and the ranks (exec'd there): sizes, the port's model,
# the dropout masks of the union batch
_COMMON = r'''
import hashlib
import zlib

import numpy as np
import torch

SIZE, BATCH, SAMPLES, BASE, STEPS = 64, 8, 8, 8, 3
K = SIZE * SIZE          # the score map's pixels: every foreground pixel is selected


def port_model(state=None):
    from celldetection_tpu_torch import models
    m = models.CpnU12(in_channels=1, max_detections=K, samples=SAMPLES, device='cpu',
                      backbone_kwargs=dict(base_channels=BASE))
    if state is not None:
        m.load_state_dict(state, strict=True)
    return m


def union_mask(head, n, channels, rate):
    """Keep mask [n, channels] of a head's dropout over the union batch."""
    return np.random.RandomState(zlib.crc32(head.encode())).rand(n, channels) >= rate


def hook_dropout(model, lo, hi):
    """The port's head dropout takes rows lo:hi of the union masks."""
    from celldetection_tpu_torch.models.commons import Dropout2d
    for name, mod in model.named_modules():
        if type(mod) is Dropout2d:
            def hook(m, inputs, output, head=name.split('.')[1]):
                x = inputs[0]
                keep = torch.from_numpy(union_mask(head, BATCH, x.shape[1], m.p)[lo:hi])
                return torch.where(keep[:, :, None, None], x / (1 - m.p), 0.)
            mod.register_forward_hook(hook)


def digest(model):
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def float64(batch):
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in batch.items()}
'''

_WORKER = _COMMON + r'''
import os
import pickle
import sys

port, rank, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
sys.path.insert(0, os.environ['CDT_REPO'])
import torch.distributed as dist
from celldetection_tpu_torch import models, parallel
from celldetection_tpu_torch.ops.loss import global_means
from celldetection_tpu_torch.parallel import mesh as tmesh
from celldetection_tpu_torch.runtime.trainer import CPNTrainer

assert parallel.initialize_distributed(f'localhost:{port}', 2, rank, device='cpu', timeout=60)
with open(os.path.join(work, 'inputs.pkl'), 'rb') as f:
    inp = pickle.load(f)
world = dist.get_world_size()
lo, hi = rank * BATCH // world, (rank + 1) * BATCH // world
local = lambda batch: {k: v[lo:hi] for k, v in batch.items()}
out = {}

# -- the cross-process norm in float64
x, dy, w, b = inp['norm']
norm = models.Norm(x.shape[1]).double().train()
norm.weight.data, norm.bias.data = torch.from_numpy(w), torch.from_numpy(b)
models.set_norm_group_(norm, dist.group.WORLD)
xr = torch.from_numpy(x[lo:hi]).requires_grad_(True)
y = norm(xr)
y.backward(torch.from_numpy(dy[lo:hi]))
out['norm'] = dict(y=y.detach().numpy(), dx=xr.grad.numpy(), dw=norm.weight.grad.numpy(),
                   db=norm.bias.grad.numpy(), mean=norm.running_mean.numpy(),
                   var=norm.running_var.numpy())

# -- every loss term's global value in float64
out['losses'] = {}
for split, batch in inp['loss_batches'].items():
    m = port_model(inp['state']).double().train()
    models.set_norm_group_(m, dist.group.WORLD)
    hook_dropout(m, lo, hi)
    b64 = {k: torch.from_numpy(v) for k, v in local(float64(batch)).items()}
    image = b64.pop('image')
    with global_means(dist.group.WORLD):
        res = m.forward_padded(image, targets=b64, generator=torch.Generator().manual_seed(0))
    keys = sorted(res['losses'])
    vals = torch.stack([res['loss'].detach()] + [res['losses'][k].detach() for k in keys])
    dist.all_reduce(vals)
    vals = (vals / world).tolist()
    out['losses'][split] = dict(zip(['loss'] + keys, vals))
    out['losses'][split + '_local_valid'] = int(res['valid'].sum())

# -- make_train_step over a mesh: three Adam steps
mesh = parallel.make_mesh()
assert parallel.mesh_spans_processes(mesh)
m = port_model(inp['state'])
hook_dropout(m, lo, hi)
state = parallel.TrainState.create(m, lambda p: torch.optim.Adam(p, lr=1e-3))
step = parallel.make_train_step(m, state.optimizer, mesh=mesh)
losses, digests, terms = [], [], []
for s in range(STEPS):
    state, metrics = step(state, local(inp['train_batch']), torch.Generator().manual_seed(s))
    losses.append(float(metrics['loss']))
    terms.append({k: float(v) for k, v in metrics.items()})
    digests.append(digest(m))
out['step'] = dict(losses=losses, terms=terms, digests=digests,
                   buffers={k: v.numpy().copy() for k, v in m.named_buffers()})

# -- CPNTrainer.fit over the mesh, dropout off; its checkpoint
m = port_model(inp['fit_state'])
for mod in m.modules():
    if isinstance(mod, models.Dropout2d):
        mod.p = 0.
tr = CPNTrainer(m, optimizer={'Adam': {'lr': 1e-3}}, mesh=mesh, seed=7, log_fn=lambda *a: None)
hist = tr.fit(inp['fit_data'], epochs=2, batch_size=BATCH, max_instances=16, samples=SAMPLES)
ckpt = os.path.join(work, 'fit.ckpt')
tr.save_checkpoint(ckpt)
out['fit'] = dict(history=hist, digest=digest(m), ckpt_seen=os.path.isfile(ckpt),
                  records=sorted(tr.gather_item_records()))

# -- host helpers and item records
tr.item_record = {rank * 10: [{'batch_loss': 1.0 + rank}], 99: [{'batch_loss': float(rank)}]}
rec = tr.gather_item_records()
out['records'] = dict(keys=sorted(rec), r99=sorted(r['batch_loss'] for r in rec[99]))
out['all_filter'] = parallel.all_filter(rank == 1)
out['reduced'] = parallel.host_all_reduce_sum(np.array([rank + 1., 10.]))
out['reduced_int'] = parallel.host_all_reduce_sum(np.array([rank + 1, 2], np.int64))
out['broadcast'] = tmesh.broadcast_from_rank0(f'from {rank}')
items = list(range(7))
out['shard'] = {lv: parallel.shard_inputs_by_process(items, lv) for lv in ('rank', 'node', 'job')}
with open(os.path.join(work, f'rank{rank}.pkl'), 'wb') as f:
    pickle.dump(out, f)
dist.barrier()
dist.destroy_process_group()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def run_ranks(worker: str, work: str, timeout: float = 420, n: int = 2) -> list:
    """Run ``worker`` as ``n`` fresh processes, ranks of one ``gloo`` group on
    localhost, one thread each; every rank's traceback reaches the failure."""
    path = os.path.join(work, 'worker.py')
    with open(path, 'w') as f:
        f.write(worker)
    env = dict(os.environ, CDT_REPO=REPO, OMP_NUM_THREADS='1', MKL_NUM_THREADS='1')
    for key in ('SLURM_NTASKS', 'SLURM_PROCID', 'WORLD_SIZE', 'RANK', 'LOCAL_RANK'):
        env.pop(key, None)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, path, str(port), str(r), work],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
             for r in range(n)]
    errs = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            errs.append(f'rank {r} (exit {p.returncode}):\n{err[-3000:]}')
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), '\n'.join(errs)
    outs = []
    for r in range(n):
        with open(os.path.join(work, f'rank{r}.pkl'), 'rb') as f:
            outs.append(pickle.load(f))
    return outs


_C = {}
exec(compile(_COMMON, '<common>', 'exec'), _C)


def _jax_batch(indices, empty=()):
    """``test_multihost_train.py``'s items (disks of the JAX package's toy
    data, its targets) at K = the pixel count; labels of ``empty`` items cleared."""
    from celldetection_tpu import data as jdata
    images, items = [], []
    for i in indices:
        img, labels = jdata.random_geometric_objects(_C['SIZE'], _C['SIZE'], num=4,
                                                     radius=(4, 10), seed=100 + i)
        if i in empty:
            labels = np.zeros_like(labels)
        images.append(img[..., None].astype(np.float32))
        items.append(jdata.cpn_targets_single(labels, _C['SAMPLES'], 5,
                                              rng=np.random.RandomState(i)))
    targets = jdata.collate_cpn_targets(items, max_instances=8)
    return {'image': np.stack(images), **{k: v for k, v in targets.items() if k != 'num_instances'}}


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    """The inputs (weights from numpy seeds, batches from the JAX package's
    toy data), the two ranks' results, and the JAX variables."""
    from celldetection_tpu import data as jdata
    from celldetection_tpu_torch.util import init_jax_variables, state_dict_from_jax
    work = str(tmp_path_factory.mktemp('ddp_train'))
    pm = _C['port_model']()
    variables = init_jax_variables(pm, 0)
    state = state_dict_from_jax(variables)
    rng = np.random.RandomState(0)
    norm = (rng.randn(8, 6, 5, 5) * 2 + 1, rng.randn(8, 6, 5, 5), rng.rand(6) + .5, rng.randn(6))
    fit_data = []
    for i in range(8):
        img, labels = jdata.random_geometric_objects(64, 64, num=4, radius=(4, 10), seed=200 + i)
        fit_data.append((img.astype(np.float32)[..., None], labels))
    inputs = dict(norm=norm, state=state, variables=variables,
                  fit_state=state_dict_from_jax(init_jax_variables(pm, 1)),
                  train_batch=_jax_batch(range(8)),
                  loss_batches={'even': _jax_batch(range(8)),
                                'empty_rank': _jax_batch(range(8), empty=range(4, 8))},
                  fit_data=fit_data)
    with open(os.path.join(work, 'inputs.pkl'), 'wb') as f:
        pickle.dump(inputs, f)
    outs = run_ranks(_WORKER, work)
    return inputs, outs, work


def test_cross_process_norm_matches_one_process(setup):
    from celldetection_tpu_torch import models
    inputs, outs, _ = setup
    x, dy, w, b = inputs['norm']
    norm = models.Norm(x.shape[1]).double().train()
    norm.weight.data, norm.bias.data = torch.from_numpy(w), torch.from_numpy(b)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = norm(xt)
    y.backward(torch.from_numpy(dy))
    a, c = outs[0]['norm'], outs[1]['norm']
    tol = dict(rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.concatenate([a['y'], c['y']]), y.detach().numpy(), **tol)
    np.testing.assert_allclose(np.concatenate([a['dx'], c['dx']]), xt.grad.numpy(), **tol)
    # the parameters' gradients are each rank's share of the union's
    np.testing.assert_allclose(a['dw'] + c['dw'], norm.weight.grad.numpy(), **tol)
    np.testing.assert_allclose(a['db'] + c['db'], norm.bias.grad.numpy(), **tol)
    for key, want in (('mean', norm.running_mean), ('var', norm.running_var)):
        np.testing.assert_array_equal(a[key], c[key])
        np.testing.assert_allclose(a[key], want.numpy(), **tol)


@pytest.mark.parametrize('split', ['even', 'empty_rank'])
def test_loss_terms_are_the_union_batch_means(setup, split):
    inputs, outs, _ = setup
    batch = _C['float64'](inputs['loss_batches'][split])
    m = _C['port_model'](inputs['state']).double().train()
    _C['hook_dropout'](m, 0, _C['BATCH'])
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    image = tb.pop('image')
    res = m.forward_padded(image, targets=tb, generator=torch.Generator().manual_seed(0))
    want = {'loss': res['loss'].item(), **{k: v.item() for k, v in res['losses'].items()}}
    got = outs[0]['losses'][split]
    assert got == outs[1]['losses'][split]
    assert set(got) == set(want) == {'loss', 'score', 'fourier', 'location', 'contour',
                                     'refinement', 'iou'}
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-12, err_msg=key)
    valid = [o['losses'][split + '_local_valid'] for o in outs]
    assert valid[0] > 0 and (valid[1] == 0) == (split == 'empty_rank')


def _port_single_steps(inputs):
    m = _C['port_model'](inputs['state'])
    _C['hook_dropout'](m, 0, _C['BATCH'])
    from celldetection_tpu_torch import parallel
    state = parallel.TrainState.create(m, lambda p: torch.optim.Adam(p, lr=1e-3))
    step = parallel.make_train_step(m, state.optimizer)
    losses = []
    for s in range(_C['STEPS']):
        state, metrics = step(state, inputs['train_batch'], torch.Generator().manual_seed(s))
        losses.append(float(metrics['loss']))
    return losses


def _jax_single_steps(inputs):
    """The JAX package's single-process steps on the union batch, as
    ``test_multihost_train.py:_single_process_reference`` runs them, with the
    port's weights (``state_dict_from_jax`` of the same variables), K the
    pixel count and the union dropout masks."""
    import flax
    import jax
    import jax.numpy as jnp
    import optax
    from celldetection_tpu import models as jmodels
    from celldetection_tpu import parallel as jparallel

    def masks(call, args, kwargs, context):
        mod = context.module
        if not isinstance(mod, flax.linen.Dropout):
            return call(*args, **kwargs)
        x = args[0]
        keep = _C['union_mask'](mod.path[0], x.shape[0], x.shape[-1], mod.rate)
        return jnp.where(jnp.asarray(keep)[:, None, None, :], x / (1. - mod.rate), 0.)

    jm = jmodels.CpnU12(in_channels=1, max_detections=_C['K'], samples=_C['SAMPLES'],
                        backbone_kwargs=dict(base_channels=_C['BASE']))
    jm.variables = jax.tree_util.tree_map(jnp.asarray, inputs['variables'])
    tx = optax.adam(1e-3)
    state = jparallel.TrainState.create(jm, tx)
    step = jparallel.make_train_step(jm, tx, mesh=None)
    losses = []
    with flax.linen.intercept_methods(masks):
        for s in range(_C['STEPS']):
            state, metrics = step(state, inputs['train_batch'], jax.random.PRNGKey(1 + s))
            losses.append(float(metrics['loss']))
    return losses


def test_train_step_over_two_ranks_matches_one_process(setup):
    inputs, outs, _ = setup
    a, b = outs[0]['step'], outs[1]['step']
    # replicated state: the same parameters after every step, the same losses
    assert a['digests'] == b['digests'] and len(set(a['digests'])) == _C['STEPS']
    assert a['terms'] == b['terms'] and a['losses'] == b['losses']
    for key in a['buffers']:
        np.testing.assert_array_equal(a['buffers'][key], b['buffers'][key], err_msg=key)
    assert all(np.isfinite(a['losses']))
    # the first step's loss is the union batch's up to float32 rounding; the
    # loss is not smooth (the refinement rounds to pixels), so the later
    # steps part by the reduction order's rounding, as two JAX runs do
    single = _port_single_steps(inputs)
    np.testing.assert_allclose(a['losses'][0], single[0], rtol=1e-6)
    np.testing.assert_allclose(a['losses'], single, rtol=1e-3)
    # test_multihost_train.py's gate against the JAX package on the union batch
    np.testing.assert_allclose(a['losses'], _jax_single_steps(inputs), rtol=1e-3)


def test_fit_over_two_ranks_matches_one_process(setup):
    from celldetection_tpu_torch import models
    from celldetection_tpu_torch.runtime.trainer import CPNTrainer
    inputs, outs, work = setup
    a, b = outs[0]['fit'], outs[1]['fit']
    assert a['digest'] == b['digest'] and a['history'] == b['history']
    assert a['ckpt_seen'] and b['ckpt_seen']
    assert a['records'] == b['records'] == list(range(8))
    m = _C['port_model'](inputs['fit_state'])
    for mod in m.modules():
        if isinstance(mod, models.Dropout2d):
            mod.p = 0.
    tr = CPNTrainer(m, optimizer={'Adam': {'lr': 1e-3}}, seed=7, log_fn=lambda *a: None)
    hist = tr.fit(inputs['fit_data'], epochs=2, batch_size=_C['BATCH'], max_instances=16,
                  samples=_C['SAMPLES'])
    assert [h['epoch'] for h in a['history']] == [h['epoch'] for h in hist] == [0, 1]
    for key in ('loss', 'ema_loss'):
        np.testing.assert_allclose([h[key] for h in a['history']], [h[key] for h in hist],
                                   rtol=1e-4, err_msg=key)
    # rank 0's file is what one process writes of the same state
    ckpt = os.path.join(work, 'fit.ckpt')
    tr2 = CPNTrainer(_C['port_model'](), optimizer={'Adam': {'lr': 1e-3}},
                     log_fn=lambda *a: None)
    tr2.load_checkpoint(ckpt)
    assert _C['digest'](tr2.model) == a['digest']
    tr2.save_checkpoint(os.path.join(work, 'again.ckpt'))
    with open(ckpt, 'rb') as f, open(os.path.join(work, 'again.ckpt'), 'rb') as g:
        assert f.read() == g.read()


def test_item_records_and_host_collectives_over_two_ranks(setup):
    _, outs, _ = setup
    a, b = outs
    assert a['records'] == b['records'] == dict(keys=[0, 10, 99], r99=[0.0, 1.0])
    assert a['all_filter'] == b['all_filter'] == ({1}, {0})
    for o in outs:
        np.testing.assert_array_equal(o['reduced'], [3., 20.])
        assert o['reduced_int'].dtype == np.int64
        np.testing.assert_array_equal(o['reduced_int'], [3, 4])
        assert o['broadcast'] == 'from 0'
    items = list(range(7))
    assert a['shard']['rank'] == items[0::2] and b['shard']['rank'] == items[1::2]
    assert a['shard']['node'] == a['shard']['rank'] and b['shard']['node'] == b['shard']['rank']
    assert a['shard']['job'] == b['shard']['job'] == items


@pytest.mark.parametrize('case', ['slurm', 'torchrun', 'arguments', 'one_process'])
def test_initialize_distributed_reads_the_environment(monkeypatch, case):
    from celldetection_tpu_torch.parallel import mesh as tmesh
    for key in ('SLURM_NTASKS', 'SLURM_PROCID', 'SLURM_LOCALID', 'WORLD_SIZE', 'RANK',
                'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT'):
        monkeypatch.delenv(key, raising=False)
    calls = []
    monkeypatch.setattr(tmesh.dist, 'init_process_group', lambda *a, **kw: calls.append((a, kw)))
    env = dict(slurm=dict(SLURM_NTASKS='4', SLURM_PROCID='3', SLURM_LOCALID='1', WORLD_SIZE='9',
                          RANK='7', MASTER_ADDR='node0', MASTER_PORT='1234'),
               torchrun=dict(WORLD_SIZE='2', RANK='1', LOCAL_RANK='1', MASTER_ADDR='host',
                             MASTER_PORT='29500'),
               arguments=dict(SLURM_NTASKS='4', SLURM_PROCID='3'), one_process={})[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    kw = dict(coordinator_address='here:5', num_processes=3, process_id=2) \
        if case == 'arguments' else {}
    done = tmesh.initialize_distributed(device='cpu', timeout=30, **kw)
    if case == 'one_process':
        assert done is False and calls == [] and tmesh.local_rank() == 0
        with pytest.raises(RuntimeError, match='initialize_distributed'):
            tmesh.make_mesh()
        return
    (backend,), kwargs = calls[0]
    want = dict(slurm=('tcp://node0:1234', 4, 3, 1), torchrun=('tcp://host:29500', 2, 1, 1),
                arguments=('tcp://here:5', 3, 2, 0))[case]
    assert done is True and backend == 'gloo'
    assert (kwargs['init_method'], kwargs['world_size'], kwargs['rank'],
            tmesh.local_rank()) == want
    assert kwargs['timeout'].total_seconds() == 30
    if not torch.cuda.is_available():   # a rank's card by default: none here
        with pytest.raises(RuntimeError, match='CUDA'):
            tmesh.initialize_distributed()
    assert tmesh.default_backend('cuda:1') == 'nccl' and tmesh.default_backend('cpu') == 'gloo'


def test_single_process_helpers():
    from celldetection_tpu_torch import parallel
    from celldetection_tpu_torch.parallel import mesh as tmesh
    assert parallel.all_filter(True) == ({0}, set()) and parallel.all_filter(False) == (set(), {0})
    v = np.array([1., 2.])
    assert parallel.host_all_reduce_sum(v) is v and tmesh.broadcast_from_rank0('x') == 'x'
    assert not parallel.mesh_spans_processes(None)
    assert parallel.cpu_count() >= 1


def test_task_farm_end_to_end():
    from celldetection_tpu_torch.parallel import TaskServer, query, sink
    port = _free_port()
    with TaskServer(range(10), port=port, host='127.0.0.1') as server:
        def worker():
            for task in query('127.0.0.1', port=port):
                sink('127.0.0.1', task * 2, port=port + 1)

        threads = [threading.Thread(target=worker) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        deadline = time.time() + 5
        while len(server.results) < 10 and time.time() < deadline:
            time.sleep(0.05)
        assert sorted(server.results) == [i * 2 for i in range(10)]


def test_callbacks():
    from celldetection_tpu_torch.callbacks import KeepAlive, StepDropout
    ka = KeepAlive(timeout=9999, interval=0.01).start()
    ka.ping()
    ka.stop()
    sd = StepDropout([(0, 0.1), (100, 0.0)])
    assert sd(50) == 0.1 and sd(100) == 0.0
