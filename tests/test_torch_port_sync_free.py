"""The eval step without host-device synchronisations.

On a card, a tensor built from host data (``torch.tensor``, ``torch.as_tensor``,
``Tensor.new_tensor`` of Python numbers or lists) and a list index (a CPU index
tensor) are copied from pageable memory with ``cudaMemcpyAsync`` followed by a
stream synchronisation: the host waits for every kernel queued before it, and
the next batch's launches meet an empty queue. The eval ``forward_padded`` has
none of them.

* The census (CPU): a ``TorchFunctionMode`` over one eval ``forward_padded``,
  after a warm-up call, records every such call with the port's line that
  made it; there must be none, on narrow CpnU22 in fp32, on CpnResNet18UNet
  with ``MambaLayer(dt_rank='auto')`` secondary blocks in bf16, on a narrow
  ConvNeXt UNet CPN in bf16, and for each tile forward of ``TiledInference``
  on a small mosaic.
* The rewritten helpers give the bits of the formulas they replace, copied
  here (``copied_*``, each making its constants by a copy from the host):
  ``clip``'s values and gradients (ties at both bounds, where ``jnp.clip``'s
  derivative is 1/2), ``fourier_basis``, ``fouriers2contours``,
  ``get_scale``, ``scale_contours``, ``scale_fourier`` and ``Normalize`` with
  scalar and per-channel mean and std, in fp32 and bf16.
* On a card (``cuda``): after one warm-up call, two ``forward_padded`` calls of
  the same models (and the Mamba model in fp32, on the scan kernel) run under
  ``torch.cuda.set_sync_debug_mode('error')``, and the ``cpn.forward`` span of
  a recorded call counts ``host_syncs`` 0; ``util/spans.py: host_syncs``
  counts a copy and a read back as 2; the helpers' bits hold on the card too.

The module imports neither JAX nor the JAX package: ``python -m pytest
--noconftest tests/test_torch_port_sync_free.py -m cuda`` runs it on a machine
with a card.
"""
import functools
import math
import os
import traceback

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from celldetection_tpu_torch import models as tmodels
from celldetection_tpu_torch.models.commons import Normalize
from celldetection_tpu_torch.ops import commons as tops
from celldetection_tpu_torch.ops import cpn as tcpn
from celldetection_tpu_torch.parallel import TiledInference
from celldetection_tpu_torch.util import spans

pytestmark = pytest.mark.usefixtures('one_torch_thread')

PORT = os.path.dirname(os.path.abspath(tmodels.__file__)).rsplit(os.sep, 1)[0]
DTYPES = (torch.float32, torch.bfloat16)
# the helpers' bits on the CPU, and on a card where there is one
DEVICES = ('cpu', pytest.param('cuda', marks=pytest.mark.cuda))


@pytest.fixture(scope='module')
def one_torch_thread():
    """One torch thread, as ``test_torch_port_cpn.py``'s fixture of that name."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# The census
# ---------------------------------------------------------------------------

def _port_line() -> str:
    """The innermost line of the port on the stack: the site of the call."""
    for frame in reversed(traceback.extract_stack()):
        if frame.filename.startswith(PORT):
            return f'{os.path.relpath(frame.filename, PORT)}:{frame.lineno}'
    return '?'


def _host_index(index) -> bool:
    items = index if isinstance(index, tuple) else (index,)
    return any(isinstance(i, (list, np.ndarray)) for i in items)


class HostData(TorchFunctionMode):
    """Records ``(what, port line)`` of each tensor built from host data and each
    list or array index made inside it."""

    def __init__(self):
        super().__init__()
        self.sites = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, '__name__', '')
        if name in ('tensor', 'as_tensor', 'new_tensor'):
            data = args[1] if name == 'new_tensor' else (args[0] if args else kwargs['data'])
            if not torch.is_tensor(data):
                self.sites.append((name, _port_line()))
        elif name == '__getitem__' and _host_index(args[1]):
            self.sites.append(('list index', _port_line()))
        return func(*args, **kwargs)


def census(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under :class:`HostData`: ``(result, sites)``."""
    with HostData() as mode:
        out = fn(*args, **kwargs)
    return out, mode.sites


def _u22(device='cpu', **kw):
    torch.manual_seed(0)
    return tmodels.CpnU22(in_channels=3, max_detections=64, samples=16, device=device,
                          backbone_kwargs=dict(base_channels=8), **kw).eval()


def _mamba(device='cpu', compute_dtype=torch.bfloat16):
    torch.manual_seed(1)
    return tmodels.CpnResNet18UNet(
        3, max_detections=64, samples=16, device=device, compute_dtype=compute_dtype,
        backbone_kwargs={'base_channel': 8,
                         'secondary_block': functools.partial(tmodels.MambaLayer,
                                                              dt_rank='auto')}).eval()


def _convnext(device='cpu', compute_dtype=torch.bfloat16):
    """A narrow ConvNeXt CPN (CpnConvNeXtLargeUNet's blocks and two bridge levels),
    built as the registry builds the ConvNeXt UNets."""
    from celldetection_tpu_torch.models import convnext, cpn, unet
    torch.manual_seed(2)
    backbone = unet._backbone_unet(convnext._convnext((1, 1, 2, 1), (64, 64, 128, 128)))
    return cpn._make_cpn(backbone, 3, name='CpnConvNeXtLargeUNet', max_detections=64,
                         samples=16, device=device, compute_dtype=compute_dtype).eval()


def _image(size, device='cpu', batch=1):
    g = torch.Generator().manual_seed(size)
    return torch.rand(batch, size, size, 3, generator=g).to(device)


@pytest.mark.parametrize('build, size', [(_u22, 128), (_mamba, 64), (_convnext, 64)],
                         ids=['u22_fp32', 'resnet18unet_mamba_bf16', 'convnext_unet_bf16'])
def test_eval_step_builds_no_tensor_from_host_data(build, size):
    model, x = build(), _image(size)
    with torch.no_grad():
        model.forward_padded(x, score_thresh=0.)                    # warm-up
        out, sites = census(model.forward_padded, x, score_thresh=0.)
    assert sites == []
    assert out['valid'].any()


def test_tiled_forwards_build_no_tensor_from_host_data():
    model = _u22()
    tiled = TiledInference(model, tile_size=64, stride=48, batch_size=2)
    forward, seen = tiled._tile_forward, []

    def counted(*args, **kwargs):
        out, sites = census(forward, *args, **kwargs)
        seen.append(sites)
        return out
    tiled._tile_forward = counted
    mosaic = (np.random.default_rng(0).random((160, 144, 3)) * 255).astype(np.uint8)
    tiled(mosaic, score_thresh=0.5)
    assert len(seen) >= 3       # 9 tiles, 2 a batch, then capacity retries; the first a warm-up
    assert seen[1:] == [[]] * (len(seen) - 1)


# ---------------------------------------------------------------------------
# The helpers against the formulas they replace
# ---------------------------------------------------------------------------

def copied_clip(x, lo=None, hi=None):
    if lo is not None:
        x = torch.maximum(x, x.new_tensor(lo))
    if hi is not None:
        x = torch.minimum(x, x.new_tensor(hi))
    return x


def copied_fourier_basis(order, samples=None, sampling=None, dtype=torch.float32, device=None):
    if sampling is None:
        if samples == 1:
            sampling = torch.zeros(1, dtype=dtype, device=device)
        else:
            step = torch.tensor(1. / (samples - 1), dtype=dtype, device=device)
            sampling = torch.arange(samples, dtype=dtype, device=device) * step
    k = torch.arange(1, order + 1, dtype=sampling.dtype, device=sampling.device)
    c = (2.0 * math.pi) * k[:, None] * sampling[..., None, :]
    return torch.cos(c), torch.sin(c), sampling


def copied_fouriers2contours(fourier, locations, samples=64, sampling=None):
    order = fourier.shape[-2]
    c_cos, c_sin, sampling = copied_fourier_basis(order, samples, sampling, dtype=fourier.dtype,
                                                  device=fourier.device)
    cos_coef = fourier[..., None, [0, 2]]
    sin_coef = fourier[..., None, [1, 3]]
    con = (cos_coef * c_cos[..., None]).sum(-3)
    con = con + (sin_coef * c_sin[..., None]).sum(-3)
    return con + locations[..., None, :], sampling


def copied_get_scale(actual_size, original_size, flip=True, dtype=torch.float32, device=None):
    scale = (torch.as_tensor(original_size, dtype=dtype, device=device)
             / torch.as_tensor(actual_size, dtype=dtype, device=device))
    return torch.flip(scale, (-1,)) if flip else scale


def copied_scale_contours(actual_size, original_size, contours):
    return contours * copied_get_scale(actual_size, original_size, dtype=contours.dtype,
                                       device=contours.device)


def copied_scale_fourier(actual_size, original_size, fourier, location):
    scale = copied_get_scale(actual_size, original_size, dtype=fourier.dtype,
                             device=fourier.device)
    return fourier * torch.repeat_interleave(scale, 2, -1), location * scale


def copied_normalize(x, mean, std, assert_range=(0., 1.)):
    if assert_range is not None:
        x = x.clamp(*assert_range)
    kw = dict(dtype=x.dtype, device=x.device)
    mean = torch.as_tensor(mean, **kw)
    std = torch.as_tensor(std, **kw)
    channel = (-1,) + (1,) * (x.dim() - 2)
    if mean.dim():
        mean = mean.reshape(channel)
    if std.dim():
        std = std.reshape(channel)
    return (x - mean) / std


def _on(device):
    if device == 'cuda' and not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device(device)


def _bits_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape and a.device == b.device
    assert torch.equal(a, b), (a - b).abs().max()


@pytest.mark.parametrize('device', DEVICES)
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('lo, hi', [(0, 63), (0., 1023.), (-2.5, 2.5), (1, None), (None, 3)])
def test_clip_values_and_gradients_equal_the_copied_bounds(device, dtype, lo, hi):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 257, generator=g) * 40
    for i, v in enumerate(b for b in (lo, hi) if b is not None):
        x[i, :50] = v                       # ties at each bound
    x = x.to(_on(device), dtype)
    w = torch.randn(x.shape, generator=g).to(x.device, dtype)
    got = x.clone().requires_grad_()
    want = x.clone().requires_grad_()
    y_got, y_want = tops.clip(got, lo, hi), copied_clip(want, lo, hi)
    _bits_equal(y_got, y_want)
    (y_got * w).sum().backward()
    (y_want * w).sum().backward()
    _bits_equal(got.grad, want.grad)
    tie = x == (lo if lo is not None else hi)
    assert torch.equal(got.grad[tie], w[tie] / 2)


def test_clip_of_integers_equals_the_copied_bound():
    x = torch.arange(-5, 6)
    _bits_equal(tops.clip(x - 1, 0), copied_clip(x - 1, 0))


@pytest.mark.parametrize('device', DEVICES)
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('order, samples', [(5, 32), (8, 64), (1, 2), (3, 1), (12, 100)])
def test_fourier_basis_equals_the_copied_step(device, dtype, order, samples):
    dev = _on(device)
    for got, want in zip(tcpn.fourier_basis(order, samples, dtype=dtype, device=dev),
                         copied_fourier_basis(order, samples, dtype=dtype, device=dev)):
        _bits_equal(got, want)


@pytest.mark.parametrize('device', DEVICES)
@pytest.mark.parametrize('dtype', DTYPES)
def test_fouriers2contours_equals_the_list_index(device, dtype):
    g = torch.Generator().manual_seed(4)
    dev = _on(device)
    fourier = (torch.randn(2, 7, 5, 4, generator=g) * 9).to(dev, dtype)
    loc = (torch.rand(2, 7, 2, generator=g) * 100).to(dev, dtype)
    for got, want in zip(tcpn.fouriers2contours(fourier, loc, samples=32),
                         copied_fouriers2contours(fourier, loc, samples=32)):
        _bits_equal(got, want)
    sampling = torch.rand(2, 7, 16, generator=g).to(dev, dtype)
    _bits_equal(tcpn.fouriers2contours(fourier, loc, sampling=sampling)[0],
                copied_fouriers2contours(fourier, loc, sampling=sampling)[0])


SIZES = [((64, 48), (256, 192)), ((512, 512), (1024, 1024)), ((33, 47), (131, 185)),
         ((24, 24), (97, 83)), ((3, 7), (11, 13))]


@pytest.mark.parametrize('device', DEVICES)
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('actual, original', SIZES)
def test_scales_equal_the_copied_sizes(device, dtype, actual, original):
    g = torch.Generator().manual_seed(5)
    dev = _on(device)
    for flip in (True, False):
        got = tcpn.get_scale(actual, original, flip=flip, dtype=dtype, device=dev)
        want = copied_get_scale(actual, original, flip=flip, dtype=dtype, device=dev)
        _bits_equal(got, want)
        got.zero_()                          # a caller's own tensor
        _bits_equal(tcpn.get_scale(actual, original, flip=flip, dtype=dtype, device=dev), want)
    con = (torch.rand(2, 9, 16, 2, generator=g) * 60).to(dev, dtype)
    _bits_equal(tcpn.scale_contours(actual, original, con),
                copied_scale_contours(actual, original, con))
    four = (torch.randn(2, 9, 5, 4, generator=g) * 9).to(dev, dtype)
    loc = (torch.rand(2, 9, 2, generator=g) * 60).to(dev, dtype)
    for got, want in zip(tcpn.scale_fourier(actual, original, four, loc),
                         copied_scale_fourier(actual, original, four, loc)):
        _bits_equal(got, want)


@pytest.mark.parametrize('device', DEVICES)
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('mean, std', [(0., 1.), (0.5, 0.25), (0.3, 0.7), (0.1, 3.),
                                       ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
                                       (0.2, (0.3, 0.6, 0.9)), ((0.1, 0.2, 0.3), 0.45)])
def test_normalize_equals_the_copied_mean_and_std(device, dtype, mean, std):
    g = torch.Generator().manual_seed(6)
    x = (torch.rand(2, 3, 9, 11, generator=g) * 1.4 - 0.2).to(_on(device), dtype)
    module = Normalize(mean, std)
    _bits_equal(module(x), copied_normalize(x, mean, std))
    _bits_equal(module(x[:, :, None]), copied_normalize(x[:, :, None], mean, std))   # 3-D
    module.mean, module.std = 0.25, (0.5, 1., 2.)                    # set after a call
    _bits_equal(module(x), copied_normalize(x, 0.25, (0.5, 1., 2.)))
    assert module.state_dict() == {}


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: synchronisations exist only there')
    return torch.device('cuda')


def _sync_free(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under ``set_sync_debug_mode('error')``."""
    torch.cuda.set_sync_debug_mode('error')
    try:
        return fn(*args, **kwargs)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _recorded(model, x):
    spans.reset()
    spans.enable()
    try:
        model.forward_padded(x, score_thresh=0.5)
        return spans.collect()
    finally:
        spans.disable()
        spans.reset()


@pytest.mark.cuda
@pytest.mark.parametrize('build, size, batch', [
    (_u22, 256, 1), (_mamba, 128, 4),
    (functools.partial(_mamba, compute_dtype=None), 128, 1), (_convnext, 128, 4)],
    ids=['u22_fp32', 'resnet18unet_mamba_bf16', 'resnet18unet_mamba_fp32', 'convnext_unet_bf16'])
def test_eval_step_waits_for_no_kernel_on_the_card(card, build, size, batch):
    model, x = build(device=card), _image(size, card, batch)
    with torch.no_grad():
        want = model.forward_padded(x, score_thresh=0.5)            # warm-up
        for _ in range(2):
            got = _sync_free(model.forward_padded, x, score_thresh=0.5)
        torch.cuda.synchronize()
        for k in ('boxes', 'scores', 'valid'):
            assert torch.equal(got[k], want[k])
        recs = _recorded(model, x)
    forward = [r for r in recs if r['name'] == 'cpn.forward']
    assert len(forward) == 1 and forward[0]['counts']['host_syncs'] == 0


@pytest.mark.cuda
def test_tiled_forwards_wait_for_no_kernel_on_the_card(card):
    model = _u22(device=card)
    tiled = TiledInference(model, tile_size=128, stride=96, batch_size=2)
    forward, calls = tiled._tile_forward, []

    def checked(*args, **kwargs):
        calls.append(1)
        return forward(*args, **kwargs) if len(calls) == 1 else _sync_free(forward, *args,
                                                                           **kwargs)
    tiled._tile_forward = checked
    mosaic = (np.random.default_rng(0).random((320, 288, 3)) * 255).astype(np.uint8)
    tiled(mosaic, score_thresh=0.5)
    assert len(calls) >= 3


@pytest.mark.cuda
def test_host_syncs_counts_the_synchronising_calls(card):
    spans.reset()
    spans.enable()
    try:
        with spans.span('outer'), spans.host_syncs(card):
            x = torch.tensor([1., 2.], device=card)             # a pageable copy
            x.sum().item()                                       # a read back
            x.new_full((), 3.) * x                               # neither
        recs = spans.collect()
    finally:
        spans.disable()
        spans.reset()
    assert recs[-1]['counts'] == {'host_syncs': 2}
    assert torch.cuda.get_sync_debug_mode() == 0
