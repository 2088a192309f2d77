"""The Mamba token mixer's Δ rank (``dt_rank``) and its spans.

``Mamba`` and ``MambaLayer`` take ``dt_rank``: an int, or ``'auto'`` for
``mamba_ssm``'s ``ceil(d_model / 16)``; 1, the default, is the JAX
package's layout. Checked here on the CPU at small widths:

* for ranks 1, 3 and ``'auto'``, both modules against the block's equations
  written out in float64 with the recurrence run token by token: within
  1e-5 of the output's peak (the port's scan composes the same float32
  affine maps in log-depth order, the convolutions and projections sum in
  another order);
* rank 1 keeps the JAX package's state-dict keys and shapes, and a state
  converted from the JAX package's variables still loads and gives its
  outputs (the same 1e-5 of the peak as ``test_torch_port_mamba.py``);
* under ``spans.enable()`` a Mamba CPN's forward records one ``mamba.layer``
  a ResNet stage, each over one ``mamba.scan``, with their counts;
* ``'auto'`` at the published widths 256-2048.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from celldetection_tpu.models import mamba as jmamba
from celldetection_tpu_torch import models as tmodels
from celldetection_tpu_torch.models import mamba as tmamba
from celldetection_tpu_torch.util import spans
from test_torch_port_cpn import one_torch_thread  # noqa: F401  (pytestmark)
from test_torch_port_mamba import _close, _load, _nchw, _nhwc, _perturbed

pytestmark = pytest.mark.usefixtures('one_torch_thread')


def _randomise(module, seed):
    """Every parameter drawn anew (A_log near log(1..N), so the decays stay published)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith('A_log'):
                p.add_(0.1 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(max(p[0].numel(), 1)))
    return module


def _mamba_float64(m, x):
    """The Mamba block's equations in float64, the scan token by token."""
    p = {k: v.double() for k, v in m.state_dict().items()}
    x = x.double()
    xs, z = F.linear(x, p['in_proj.weight']).chunk(2, -1)
    xs = F.conv1d(F.pad(xs.transpose(1, 2), (m.d_conv - 1, 0)), p['conv1d.weight'],
                  p['conv1d.bias'], groups=m.d_inner).transpose(1, 2)
    xs = F.silu(xs)
    low, B, C = F.linear(xs, p['x_proj.weight']).split([m.dt_rank, m.d_state, m.d_state], -1)
    delta = F.softplus(F.linear(low, p['dt_proj.weight'], p['dt_proj.bias']))
    A = -torch.exp(p['A_log'])
    state = x.new_zeros(x.shape[0], m.d_inner, m.d_state)
    ys = []
    for t in range(x.shape[1]):
        state = torch.exp(delta[:, t, :, None] * A) * state + \
            delta[:, t, :, None] * B[:, t, None, :] * xs[:, t, :, None]
        ys.append(torch.einsum('bn,bdn->bd', C[:, t], state))
    y = torch.stack(ys, 1) + xs * p['D']
    return F.linear(y * F.silu(z), p['out_proj.weight'])


@pytest.mark.parametrize('dt_rank, want', [(1, 1), (3, 3), ('auto', 3)])
def test_mamba_and_layer_of_each_rank_match_the_recurrence(dt_rank, want):
    d_model = 40                                           # 'auto': ceil(40 / 16) = 3
    m = _randomise(tmamba.Mamba(d_model, d_state=8, d_conv=4, expand=2, dt_rank=dt_rank), 1)
    assert m.dt_rank == want
    assert tuple(m.x_proj.weight.shape) == (want + 16, 80)
    assert tuple(m.dt_proj.weight.shape) == (80, want)
    x = torch.randn(2, 37, d_model, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        _close(m(x).numpy(), _mamba_float64(m, x).numpy())
    layer = _randomise(tmamba.MambaLayer(d_model, d_state=8, dt_rank=dt_rank), 3)
    assert layer.mamba.dt_rank == want
    img = torch.randn(2, d_model, 5, 7, generator=torch.Generator().manual_seed(4)) * 2 + 1
    with torch.no_grad():
        seq = img.flatten(2).transpose(1, 2).double()
        normed = F.layer_norm(seq, (d_model,), layer.norm.weight.double(),
                              layer.norm.bias.double(), 1e-6)
        want_out = (seq + _mamba_float64(layer.mamba, normed)).transpose(1, 2).reshape(img.shape)
        _close(layer(img).numpy(), want_out.numpy())


def test_rank_one_is_the_jax_layout():
    m = tmamba.Mamba(6, d_state=8, d_conv=3, expand=2)
    want = {'in_proj.weight': (24, 6), 'conv1d.weight': (12, 1, 3), 'conv1d.bias': (12,),
            'x_proj.weight': (17, 12), 'dt_proj.weight': (12, 1), 'dt_proj.bias': (12,),
            'A_log': (12, 8), 'D': (12,), 'out_proj.weight': (6, 12)}
    assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == want
    assert list(m.state_dict()) == list(tmamba.Mamba(6, 8, 3, 2, dt_rank=1).state_dict())
    layer = tmamba.MambaLayer(6)
    assert layer.mamba.dt_rank == 1
    assert {k: tuple(v.shape) for k, v in layer.state_dict().items()} == {
        'norm.weight': (6,), 'norm.bias': (6,), 'mamba.in_proj.weight': (24, 6),
        'mamba.conv1d.weight': (12, 1, 4), 'mamba.conv1d.bias': (12,),
        'mamba.x_proj.weight': (33, 12), 'mamba.dt_proj.weight': (12, 1),
        'mamba.dt_proj.bias': (12,), 'mamba.A_log': (12, 16), 'mamba.D': (12,),
        'mamba.out_proj.weight': (6, 12)}
    # a state converted from the JAX package's variables loads and gives its outputs
    rng = np.random.RandomState(5)
    img = rng.randn(2, 5, 7, 6).astype(np.float32) * 2 + 1
    jl = jmamba.MambaLayer()
    v = _perturbed(jax.jit(jl.init)(jax.random.PRNGKey(2), jnp.asarray(img)), 6)
    port = _load(tmamba.MambaLayer(6, dt_rank=1), v)
    with torch.no_grad():
        _close(_nhwc(port(_nchw(img))), jax.jit(jl.apply)(v, jnp.asarray(img)))


def test_spans_of_a_mamba_cpn_forward():
    model = tmodels.CpnResNet50UNet(3, max_detections=64, device='cpu', backbone_kwargs={
        'base_channel': 8, 'secondary_block': functools.partial(tmodels.MambaLayer,
                                                                 dt_rank='auto')}).eval()
    x = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    spans.reset()
    spans.enable()
    try:
        with torch.no_grad():
            model.forward_padded(x, score_thresh=0.5, nms=True)
        recs = spans.collect()
    finally:
        spans.disable()
        spans.reset()
    by_id = {r['id']: r for r in recs}
    layers = [r for r in recs if r['name'] == 'mamba.layer']
    scans = [r for r in recs if r['name'] == 'mamba.scan']
    assert len(layers) == len(scans) == 4                    # one a ResNet stage
    for i, (layer, scan) in enumerate(zip(layers, scans)):
        c, tokens = 32 * 2 ** i, (16 // 2 ** i) ** 2
        assert by_id[layer['parent']]['name'] == 'cpn.core'
        assert scan['parent'] == layer['id']
        assert layer['counts'] == dict(batch=1, tokens=tokens, d_model=c, d_inner=2 * c,
                                       d_state=16, dt_rank=math.ceil(c / 16))
        assert scan['counts'] == dict(batch=1, tokens=tokens, d_inner=2 * c, d_state=16,
                                      elem_bytes=4)
    # off a profiler and without enable(), nothing is recorded
    with torch.no_grad():
        model.forward_padded(x, score_thresh=0.5, nms=True)
    assert spans.collect() == []


def test_auto_rank_at_the_published_widths():
    for d_model, rank in ((256, 16), (512, 32), (1024, 64), (2048, 128)):
        assert tmamba.resolve_dt_rank('auto', d_model) == rank == math.ceil(d_model / 16)
        with torch.device('meta'):
            layer = tmamba.MambaLayer(d_model, dt_rank='auto')
        assert tuple(layer.mamba.x_proj.weight.shape) == (rank + 32, 2 * d_model)
        assert tuple(layer.mamba.dt_proj.weight.shape) == (2 * d_model, rank)
        assert tuple(layer.mamba.dt_proj.bias.shape) == (2 * d_model,)
    for bad in (0, -1, 2.0, 'full', True):
        with pytest.raises(ValueError):
            tmamba.Mamba(16, dt_rank=bad)
