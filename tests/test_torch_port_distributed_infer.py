"""Port parity: tiled inference, validation and the CLI over two processes.

Two real processes (``gloo`` on the CPU, one torch thread each) run the
port's multi-process inference paths once on a tiny CpnU22 (base 8, the
weights and the score threshold of ``test_torch_port_tiles.py``), and the
tests hold them against one process and the JAX package:

* ``multihost_tiled_inference`` on ``tests/test_multihost.py``'s image (200^2
  disks, tile 64, stride 48, 16 tiles; ``TiledInference(mesh=)`` takes the
  same path): equal across the ranks, the same kept detections as the port's
  single-process ``TiledInference``, and within ``test_torch_port_tiles.py``'s
  gates of the JAX package's ``TiledInference``; also with a foreground mask,
  and on a one-tile image, where one rank has no tile; its ``ranks.*`` spans
  (``util/spans.py``) against its stats;
* ``CPNTrainer.validate(distributed=True)`` over 4 images against one
  process's ``validate``: the same metrics and ``best_hparams``;
* ``cpn_inference`` in a group of two ranks under ``'rank'`` (two arrays: one
  each), ``'job'`` and ``'node'`` (one array, its tiles split): the same files
  as one process writes, each input written by one rank; ``skip_existing``
  decided by rank 0 for both;
* in this process: ``main()`` with ``--devices 2 --accelerator cpu`` starts
  two ranks itself and writes the same file as one process.
"""
import importlib
import os
import pickle

import numpy as np
import pytest
import torch

from test_torch_port_cpn import one_torch_thread  # noqa: F401  (pytestmark)
from test_torch_port_distributed import run_ranks

pytestmark = pytest.mark.usefixtures('one_torch_thread')

TILE, STRIDE, CAPACITY = 64, 48, 128

_WORKER = r'''
import os
import pickle
import sys

import numpy as np
import torch

port, rank, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
sys.path.insert(0, os.environ['CDT_REPO'])
import torch.distributed as dist
from celldetection_tpu_torch import models, parallel
import importlib
cli = importlib.import_module('celldetection_tpu_torch.runtime.cpn_inference')
TILE, STRIDE = 64, 48
from celldetection_tpu_torch.runtime.trainer import CPNTrainer

assert parallel.initialize_distributed(f'localhost:{port}', 2, rank, device='cpu', timeout=60)
with open(os.path.join(work, 'inputs.pkl'), 'rb') as f:
    inp = pickle.load(f)
model = models.CpnU22(device='cpu', **inp['model_kw'])
model.load_state_dict(inp['state'], strict=True)
thresh, kw = inp['thresh'], inp['tiled_kw']
out = {}

tiled = parallel.TiledInference(model, **kw)
from celldetection_tpu_torch.util import spans
spans.enable()
res = parallel.multihost_tiled_inference(tiled, inp['image'], score_thresh=thresh)
spans.disable()
out['spans'], out['stats'] = spans.collect(), dict(tiled.stats)
spans.reset()
out['multihost'] = res
out['passes'] = [[p['name'] for p in tiled.stats[k]] for k in ('nms', 'final_nms')]
out['exchange_bytes'] = tiled.stats['exchange_bytes']

# a suppression chain across the ranks: rank 0's stitch kept A and
# suppressed B; rank 1's kept C, above A, which suppresses A but not B, and
# suppressed D
from celldetection_tpu_torch.parallel.tiles import _exchange, _final_rounds
s2 = 2 * model.samples
width = s2 + 10 + 4 * model.order
def packed(boxes, scores, order):
    t = torch.zeros((len(scores), width))
    if len(scores):
        t[:, s2:s2 + 4], t[:, s2 + 4] = torch.tensor(boxes), torch.tensor(scores)
        t[:, -1] = torch.tensor(order, dtype=torch.float32)
    return t
a, b, c, d = [0., 0., 10., 10.], [0., 6., 10., 16.], [0., -6., 10., 4.], [2., -6., 12., 4.]
local, pool = ((packed([a], [.9], [0]), packed([b], [.8], [1])) if rank == 0 else
               (packed([c], [.95], [2]), packed([d], [.7], [3])))   # C suppresses D throughout
chain = parallel.TiledInference(model, **kw)
cat, _, _ = _exchange(local, dist.group.WORLD)
det, keep, _, _ = _final_rounds(chain, cat, pool, dist.group.WORLD)
out['chain'] = dict(kept=det['boxes'][keep].tolist(), rounds=chain.stats['rounds'],
                    restored=chain.stats['restored'])
meshed = parallel.TiledInference(model, mesh=parallel.make_mesh(), **kw)
out['mesh'] = meshed(inp['image'], score_thresh=thresh)
out['mask'] = meshed(inp['image'], score_thresh=thresh, mask=inp['mask'])
out['one_tile'] = meshed(inp['image'][:TILE, :TILE], score_thresh=thresh)

tr = CPNTrainer(model, val_hparams=inp['val_hparams'], log_fn=lambda *a: None)
out['validate'] = tr.validate(inp['val_data'], iou_threshs=(0.3, 0.5), distributed=True)
out['val_counts'] = [r['counts'] for r in tr.val_results]

written = []
write = cli.write_outputs
cli.write_outputs = lambda outputs, computed, args: (written.append(computed['name']),
                                                     write(outputs, computed, args))
ckw = dict(tile_size=TILE, stride=STRIDE, score_thresh=thresh, accelerator='cpu',
           flat_labels=True)
images = [inp['image'], inp['image'][:120, :150]]
out['rank'] = cli.cpn_inference(images, model, outputs=os.path.join(work, 'rank_out'),
                                group_level='rank', **ckw)
out['job'] = cli.cpn_inference(images[:1], model, outputs=os.path.join(work, 'job_out'),
                               group_level='job', **ckw)
out['skip'] = cli.cpn_inference(images[:1], model, outputs=os.path.join(work, 'job_out'),
                                group_level='job', skip_existing=True, **ckw)
os.environ.update(SLURM_NODEID='0', SLURM_NNODES='1')     # both ranks on one node
out['node'] = cli.cpn_inference(images[:1], model, outputs=os.path.join(work, 'node_out'),
                                group_level='node', **ckw)
out['written'] = written
with open(os.path.join(work, f'rank{rank}.pkl'), 'wb') as f:
    pickle.dump(out, f)
dist.barrier()
dist.destroy_process_group()
'''


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    from celldetection_tpu import data as jdata
    from test_torch_port_tiles import make_models, threshold_in_gap
    work = str(tmp_path_factory.mktemp('ddp_infer'))
    pm, jm = make_models(0, capacity=CAPACITY)
    img, _ = jdata.random_geometric_objects(200, 200, num=20, radius=(6, 12), seed=3)
    image = img.astype(np.float32)
    thresh = threshold_in_gap(jm, image, 10, 100)
    mask = np.zeros(image.shape, np.float32)
    mask[:110, :140] = 1.
    val_data = []
    for i in range(4):
        im, labels = jdata.random_geometric_objects(96, 96, num=6, radius=(6, 12), seed=40 + i)
        val_data.append((im.astype(np.float32)[..., None], labels))
    inputs = dict(model_kw=dict(in_channels=1, max_detections=CAPACITY, samples=8,
                                backbone_kwargs=dict(base_channels=8)),
                  state=pm.state_dict(), thresh=thresh, image=image, mask=mask,
                  tiled_kw=dict(tile_size=TILE, stride=STRIDE, max_outputs=512),
                  val_data=val_data,
                  val_hparams={'score_thresh': [thresh, 0.5], 'nms_thresh': [0.2, 0.5]})
    with open(os.path.join(work, 'inputs.pkl'), 'wb') as f:
        pickle.dump(inputs, f)
    outs = run_ranks(_WORKER, work)
    return pm, jm, inputs, outs, work


def _same(a, b):
    """The same result dicts, bit for bit."""
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def _by_box(res):
    """A result's detections in a canonical order (by score, then box)."""
    order = np.lexsort(tuple(res['boxes'].T[::-1]) + (-res['scores'],))
    return {k: res[k][order] for k in ('contours', 'boxes', 'scores', 'classes', 'locations',
                                        'fourier')}


def _same_kept(got, want):
    assert got['num_valid'] == want['num_valid'] > 0
    assert got['num_tiles'] == want['num_tiles'] and got['overflow'] == want['overflow']
    _same(_by_box(got), _by_box(want))


@pytest.mark.parametrize('case', ['multihost', 'mesh', 'mask', 'one_tile'])
def test_multihost_tiled_inference_matches_one_process(setup, case):
    from celldetection_tpu_torch.parallel import TiledInference
    pm, _, inputs, outs, _ = setup
    a, b = outs[0][case], outs[1][case]
    _same(a, b)                     # replicated: every rank holds the same result
    image = inputs['image'][:TILE, :TILE] if case == 'one_tile' else inputs['image']
    kw = dict(mask=inputs['mask']) if case == 'mask' else {}
    want = TiledInference(pm, **inputs['tiled_kw'])(image, score_thresh=inputs['thresh'], **kw)
    _same_kept(a, want)
    if case == 'multihost':
        assert a['num_tiles'] == 16 and not a['overflow']
        # the local stitches each ran one exact pass, the final NMS one over
        # the kept rows of both ranks, exchanged padded to the larger count
        for o in outs:    # each local stitch one exact pass, each final round one
            assert o['passes'][0] == ['exact'] and set(o['passes'][1]) == {'exact'}
            assert o['exchange_bytes'] > 0
    if case == 'one_tile':
        assert a['num_tiles'] == 1


def test_multihost_stats_are_their_ranks_spans(setup):
    """Each rank's ``ranks.call`` holds its tiling, forwards, local stitch,
    exchanges and final rounds; the stats are the spans' ms."""
    _, _, _, outs, _ = setup
    for o in outs:
        by, st = {}, o['stats']
        for r in o['spans']:
            by.setdefault(r['name'], []).append(r)
        (call,), (rounds,) = by['ranks.call'], by['ranks.final_rounds']
        assert call['parent'] is None and call['host_ms'] == st['total_ms']
        assert all(r['request'] == call['id'] for r in o['spans'])
        assert by['tiled.tile_image'][0]['counts'] == {'tiles_cut': 16, 'tiles_kept': 8}
        ex = by['ranks.exchange']
        assert ex[0]['parent'] == call['id'] and ex[0]['counts']['rows'] > 0
        restores = [r for r in ex if r['parent'] == rounds['id']]
        assert len(restores) == len(ex) - 1 == st['rounds']    # one exchange after each round
        assert sum(r['host_ms'] for r in ex) == pytest.approx(st['exchange_ms'])
        assert st['final_nms_ms'] == pytest.approx(
            rounds['host_ms'] - sum(r['host_ms'] for r in restores))
        assert sum(r['counts']['bytes'] for r in ex) == st['exchange_bytes']
        assert rounds['counts'] == {'rounds': st['rounds'], 'restored': st['restored']}
        assert 'restore_exchange_ms' not in st


def test_final_nms_restores_rows_of_a_chain_across_ranks(setup):
    """Rank 0's stitch kept A and suppressed B; rank 1 kept C, which
    suppresses A and not B, and suppressed D, which C suppresses. The
    one-process NMS over A, B, C, D keeps C and B; the JAX package's
    two-stage stitch keeps C alone."""
    _, _, _, outs, _ = setup
    for o in outs:
        assert sorted(o['chain']['kept']) == [[0., -6., 10., 4.], [0., 6., 10., 16.]]
        assert (o['chain']['rounds'], o['chain']['restored']) == (2, 1)


def test_multihost_tiled_inference_matches_jax(setup):
    from test_torch_port_tiles import assert_same_detections
    from celldetection_tpu.parallel import TiledInference as JaxTiled
    _, jm, inputs, outs, _ = setup
    want = JaxTiled(jm, tile_size=TILE, stride=STRIDE, max_outputs=512)(
        inputs['image'], score_thresh=inputs['thresh'])
    assert_same_detections(outs[0]['multihost'], want)


def test_distributed_validate_matches_one_process(setup):
    from celldetection_tpu_torch.runtime.trainer import CPNTrainer
    pm, _, inputs, outs, _ = setup
    tr = CPNTrainer(pm, val_hparams=inputs['val_hparams'], log_fn=lambda *a: None)
    want = tr.validate(inputs['val_data'], iou_threshs=(0.3, 0.5))
    a, b = outs[0]['validate'], outs[1]['validate']
    assert a == b and a['best_hparams'] == want['best_hparams']
    assert set(a) == set(want)
    for key, value in want.items():
        if key != 'best_hparams':
            np.testing.assert_allclose(a[key], value, rtol=1e-12, err_msg=key)
    # each rank matched its own images: 0 and 2, and 1 and 3
    for r, o in enumerate(outs):
        for got, full in zip(o['val_counts'], tr.val_results):
            np.testing.assert_array_equal(got, full['counts'][r::2])


def _files(out_dir, name, keys=('contours', 'scores', 'boxes', 'classes', 'flat_labels')):
    from celldetection_tpu_torch.util import io as tio
    return tio.from_h5(os.path.join(out_dir, f'{name}.h5'), *keys)


def test_cpn_inference_over_two_ranks_writes_one_process_files(setup, tmp_path):
    cli = importlib.import_module('celldetection_tpu_torch.runtime.cpn_inference')
    pm, _, inputs, outs, work = setup
    kw = dict(tile_size=TILE, stride=STRIDE, score_thresh=inputs['thresh'], accelerator='cpu',
              flat_labels=True)
    images = [inputs['image'], inputs['image'][:120, :150]]
    ref = str(tmp_path / 'ref')
    want = cli.cpn_inference(images, pm, outputs=ref, **kw)
    # 'rank': each input on one rank, bit for bit as one process writes it
    assert outs[0]['written'][:1] == ['array0'] and outs[1]['written'][:1] == ['array1']
    assert len(outs[0]['rank']) == len(outs[1]['rank']) == 1
    for name in ('array0', 'array1'):
        for got, exp in zip(_files(os.path.join(work, 'rank_out'), name), _files(ref, name)):
            np.testing.assert_array_equal(got, exp, err_msg=name)
    # 'job' and 'node': one input, its tiles split; rank 0 writes; the kept
    # set is one process's (the rows in rank order)
    assert outs[0]['written'][1:] == ['array0', 'array0'] and outs[1]['written'][1:] == []
    for level in ('job', 'node'):
        _same(outs[0][level][0], outs[1][level][0])
        _same_kept(outs[0][level][0], want[0])
        got = _files(os.path.join(work, f'{level}_out'), 'array0')
        exp = _files(ref, 'array0')
        np.testing.assert_array_equal(got[4], exp[4])          # the flat labels
        order = np.lexsort(tuple(got[2].T[::-1]) + (-got[1],))
        order_exp = np.lexsort(tuple(exp[2].T[::-1]) + (-exp[1],))
        for g, e in zip(got[:4], exp[:4]):
            np.testing.assert_array_equal(g[order], e[order_exp])
    assert outs[0]['skip'] == outs[1]['skip'] == []


def test_main_starts_ranks_for_devices(setup, tmp_path, monkeypatch):
    import imageio
    cli = importlib.import_module('celldetection_tpu_torch.runtime.cpn_inference')
    from celldetection_tpu_torch.util.serialization import save_model
    pm, _, inputs, _, _ = setup
    png = str(tmp_path / 'cells.png')
    imageio.imwrite(png, (inputs['image'] * 255).astype(np.uint8))
    cdt = str(tmp_path / 'model.cdt')
    save_model(cdt, pm)
    monkeypatch.setenv('OMP_NUM_THREADS', '1')     # the ranks compute as this process does
    args = ['-i', png, '-m', cdt, '--tile_size', str(TILE), '--stride', str(STRIDE),
            '--score_thresh', str(inputs['thresh']), '--accelerator', 'cpu']
    cli.main(args + ['-o', str(tmp_path / 'two'), '--devices', '2', '--group_level', 'job'])
    cli.main(args + ['-o', str(tmp_path / 'one')])
    keys = ('contours', 'scores', 'boxes', 'classes')
    got, exp = (_files(str(tmp_path / d), 'cells', keys) for d in ('two', 'one'))
    order = np.lexsort(tuple(got[2].T[::-1]) + (-got[1],))
    order_exp = np.lexsort(tuple(exp[2].T[::-1]) + (-exp[1],))
    assert len(order) == len(order_exp) > 0
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g[order], e[order_exp])
    # more ranks than cards raise unless each rank's device is named
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match='rank_devices'):
            cli.cpn_inference([inputs['image']], pm, outputs=str(tmp_path / 'x'), devices=2)
    with pytest.raises(ValueError, match='num_nodes'):
        cli.cpn_inference([inputs['image']], pm, outputs=str(tmp_path / 'x'), num_nodes=2,
                          accelerator='cpu')
