"""What every cell shares: the cell's files found by name, the program's model, the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<config>.json``,
with its plain reference ``reference/<config>.py``) and a traffic mix
(``mixes/<traffic>.json``, whose ``kind`` names the driver
``drivers/<kind>.py``); its limits are ``limits/<cell>.json``; each per-layer
metric is read by ``layer_metrics/<metric>.py``. A new cell, configuration,
mix or metric is a new file of its own.

Two hooks let a configuration say more than sizes, as data and reference:

- ``backbone_kwargs`` in the configuration's file goes to the model's
  constructor (:func:`backbone_kwargs`). A value ``{"module": <name>, ...}``
  there becomes ``functools.partial(celldetection_tpu_torch.models.<name>,
  ...)`` for a name of that package's ``__all__``, as
  ``{"secondary_block": {"module": "MambaLayer", "d_state": 16}}``; every
  other value goes as it is. A configuration without the key builds with no
  ``backbone_kwargs`` argument.
- ``init_weights(p, cfg, gen)`` in the reference module sets leaves of the
  weights ``p`` in place (:func:`cell_weights`): after the default draw of
  :mod:`.weights`, before the configuration's ``weight_factors``, from a
  generator of its own, so every leaf it leaves alone is the default's bit
  for bit.
"""
import functools
import importlib
import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field

import torch

from . import weights as weights_lib

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'celldetection_tpu')
DTYPES = {'fp32': None, 'bf16': torch.bfloat16}


def _json(path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One cell with everything its name leads to."""
    name: str
    entry: dict
    cfg: dict
    mix: dict
    limits: dict
    ref: object                     # the configuration's reference module
    end_to_end: list
    per_layer: list
    device: torch.device = field(default_factory=lambda: torch.device('cuda', 0))


def load_cell(name: str, bench: dict = None, device=None) -> Cell:
    bench = bench or _json(os.path.join(ROOT, 'BENCHMARK.json'))
    entry = next((w for w in bench['workloads'] if w['name'] == name), None)
    if entry is None:
        raise SystemExit(f'no workload {name!r} in BENCHMARK.json')
    conf = next(c for c in bench['configs'] if c['name'] == entry['config'])
    cfg = _json(os.path.join(ROOT, conf['file']))
    mix = _json(os.path.join(HERE, 'mixes', f"{entry['traffic']}.json"))
    limits = _json(os.path.join(HERE, 'limits', f'{name}.json'))
    ref = importlib.import_module(f"h100_bench.reference.{entry['config']}")
    e2e = [m for m in bench['end_to_end'] if name in m.get('workloads', [name])]
    layer = [m for m in bench['per_layer'] if name in m.get('workloads', [name])]
    return Cell(name, entry, cfg, mix, limits, ref, e2e, layer,
                torch.device(device) if device is not None else torch.device('cuda', 0))


def driver(cell: Cell):
    return importlib.import_module(f"h100_bench.drivers.{cell.mix['kind']}")


def cell_weights(cell: Cell, seed: int) -> dict:
    """The cell's weights from ``seed``: the default draw of the reference's
    shapes, then its ``init_weights`` where it has one, then ``weight_factors``."""
    cfg, init = cell.cfg, getattr(cell.ref, 'init_weights', None)
    return weights_lib.make_weights(
        cell.ref.shapes(cfg), seed, cell.device, cfg.get('weight_factors', ()),
        None if init is None else lambda p, gen: init(p, cfg, gen))


def backbone_kwargs(cell: Cell) -> dict:
    """The configuration's ``backbone_kwargs`` as the constructor takes them:
    each value ``{"module": <name>, **options}`` made ``functools.partial(
    celldetection_tpu_torch.models.<name>, **options)``."""
    from celldetection_tpu_torch import models
    out = {}
    for key, value in cell.cfg['backbone_kwargs'].items():
        if isinstance(value, dict) and 'module' in value:
            options = dict(value)
            name = options.pop('module')
            if name not in models.__all__:
                raise ValueError(f"configuration {cell.entry['config']!r}: backbone_kwargs "
                                 f"{key!r} names module {name!r}, which is not in "
                                 f"celldetection_tpu_torch.models.__all__")
            value = functools.partial(getattr(models, name), **options)
        out[key] = value
    return out


def build_program(cell: Cell, weights: dict = None):
    """The program's CPN of the configuration, on the cell's device, with
    ``weights`` (with the constructor's own state where it is None)."""
    from celldetection_tpu_torch.models import cpn as port_cpn
    cfg = cell.cfg
    kwargs = {k: cfg[k] for k in ('order', 'samples', 'max_detections', 'refinement_iterations',
                                  'nms_thresh', 'refinement_margin')}
    if 'backbone_kwargs' in cfg:
        kwargs['backbone_kwargs'] = backbone_kwargs(cell)
    with torch.device(cell.device):
        model = port_cpn.get_cpn(cfg['model'])(
            cfg['in_channels'], device=cell.device, torch_init=False,
            compute_dtype=DTYPES[cell.mix['precision']], **kwargs)
    if weights is not None:
        model.load_state_dict(weights, strict=True)
    return model.eval()


def read_layer_metrics(cell: Cell, data: dict) -> dict:
    """Each per-layer metric of the cell by its reader; a reader that finds nothing is left out."""
    out = {}
    for m in cell.per_layer:
        path = os.path.join(HERE, 'layer_metrics', f"{m['name']}.py")
        spec = importlib.util.spec_from_file_location(
            'h100_bench_metric_' + m['name'].replace('.', '_').replace('-', '_'), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(data)
        if value is not None:
            out[m['name']] = {'value': float(value), 'unit': m['unit']}
    return out


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's or the JAX package's."""
    return sorted({n.split('.')[0] for n in list(sys.modules)} & set(FORBIDDEN))


def compare(numbers: dict, limits: dict):
    """``(correct, checks)``: each number beside its limit; a number over its limit fails."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        if name not in numbers:
            ok = False
            checks[name] = {'value': None, 'limit': limit}
            continue
        value = numbers[name]
        ok &= value <= limit
        checks[name] = {'value': value, 'limit': limit}
    return bool(ok), checks


def reset_peak(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def peak_bytes(dev) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == 'cuda' else 0
