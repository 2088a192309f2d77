"""The CPN heads' first convolution: ``models/commons.py: head_conv`` and its kernel.

``kernels/head_conv.py: head_conv_plain`` repeats the kernel's arithmetic
(fp32 sums of the bf16 operands' exact products, the bias in fp32, one
rounding to bf16); here it is held against ``F.conv2d`` in fp32 and against
the implicit GEMM the kernel computes, written out tap by tap in float64 on
the kernel's weight layout. The dispatch rule (``takes``, which
``head_conv`` alone asks) is held on stand-ins that carry only what the rule
reads, since this machine has no card; the paths it leaves to the library
are held bit for bit against ``F.conv2d``/``F.conv3d`` and the modules, and
launch nothing (``kernels.LAUNCHES``). The test marked ``cuda`` holds the kernel against its plain
version on the card and skips without one. The module imports neither JAX
nor the JAX package: ``python -m pytest --noconftest
tests/test_torch_port_head_conv.py -m cuda`` runs it on a machine with a card.
"""
from dataclasses import dataclass

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from celldetection_tpu_torch.kernels import LAUNCHES
from celldetection_tpu_torch.kernels import head_conv as kernel_module
from celldetection_tpu_torch.kernels.head_conv import head_conv_kernel, head_conv_plain
from celldetection_tpu_torch.models import commons
from celldetection_tpu_torch.models.commons import ReadOut, head_conv
from celldetection_tpu_torch.util import spans

pytestmark = pytest.mark.usefixtures('one_torch_thread')


@pytest.fixture(scope='module')
def one_torch_thread():
    """One torch thread, as ``test_torch_port_cpn.py``'s fixture of that name."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def operands(seed, batch, cin, cout, k, h, w, bias=True):
    """bf16 operands (so fp32 holds their products exactly), x channels-last."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((batch, cin, h, w), np.float32)).bfloat16()
    wt = torch.from_numpy(rng.standard_normal((cout, cin, k, k), np.float32)
                          / np.sqrt(cin * k * k)).bfloat16()
    b = torch.from_numpy(rng.standard_normal(cout, np.float32)).bfloat16() if bias else None
    return x.contiguous(memory_format=torch.channels_last), wt, b


def implicit_gemm(x, weight, bias):
    """The kernel's GEMM in float64: rows the NHWC pixels, columns Cout, depth
    the taps x Cin of the ``[Cout, K, K, Cin]`` weights, the input read at
    ``(y + kh - P, x + kw - P)`` and zero outside."""
    k = weight.shape[-1]
    p = k // 2
    xs = np.pad(x.permute(0, 2, 3, 1).double().numpy(), ((0, 0), (p, p), (p, p), (0, 0)))
    wt = weight.permute(0, 2, 3, 1).double().numpy()
    bsz, h, w = x.shape[0], x.shape[2], x.shape[3]
    out = np.zeros((bsz, h, w, weight.shape[0]))
    for kh in range(k):
        for kw in range(k):
            out += xs[:, kh:kh + h, kw:kw + w, :] @ wt[:, kh, kw, :].T
    if bias is not None:
        out += bias.double().numpy()
    return out


def within_rounding(got, want, depth, half_ulps=1):
    """``got`` (bf16) is ``want`` rounded to bf16 within ``half_ulps`` halves
    of a bf16 ulp (2^-8 of the value each), up to the error of fp32 sums of
    ``depth`` terms; both are tensors, compared on their device in float64."""
    got, want = got.double(), want.double()
    return (got - want).abs() <= (half_ulps * 2. ** -8 * want.abs()
                                  + depth * 2. ** -23 * want.abs().max())


@pytest.mark.parametrize('k', [3, 5, 7])
@pytest.mark.parametrize('cin, cout', [(64, 128), (128, 64)])
@pytest.mark.parametrize('batch, h, w', [(1, 11, 19), (2, 6, 23)])
def test_plain_matches_conv2d_and_the_implicit_gemm(k, cin, cout, batch, h, w):
    x, wt, b = operands(k * 100 + cin + batch, batch, cin, cout, k, h, w)
    got = head_conv_plain(x, wt, b)
    assert got.dtype == torch.bfloat16 and got.shape == (batch, cout, h, w)
    assert got.is_contiguous(memory_format=torch.channels_last)
    ref = F.conv2d(x.float(), wt.float(), b.float(), padding=k // 2)
    assert torch.equal(got, ref.bfloat16())
    gemm = torch.from_numpy(implicit_gemm(x, wt, b).transpose(0, 3, 1, 2))
    assert within_rounding(got, gemm, cin * k * k).all()


def test_plain_without_bias_and_on_zeros():
    x, wt, _ = operands(3, 1, 64, 64, 7, 9, 9, bias=False)
    got = head_conv_plain(x, wt, None)
    gemm = torch.from_numpy(implicit_gemm(x, wt, None).transpose(0, 3, 1, 2))
    assert within_rounding(got, gemm, 64 * 49).all()
    b = torch.linspace(-2, 2, 64).bfloat16()
    assert torch.equal(head_conv_plain(torch.zeros_like(x), wt, b),
                       b[None, :, None, None].expand(1, 64, 9, 9))
    # a CPU tensor takes the plain version
    assert torch.equal(head_conv_kernel(x, wt, None), got)


@dataclass
class Like:
    """What the dispatch rule reads of a tensor, without a card."""
    shape: tuple
    dtype: torch.dtype = torch.bfloat16
    device: str = 'cuda'
    requires_grad: bool = False

    @property
    def is_cuda(self):
        return self.device == 'cuda'

    def dim(self):
        return len(self.shape)


@pytest.fixture
def routes(monkeypatch):
    """Replaces the kernel and the library calls by stubs naming their route."""
    monkeypatch.setattr(commons, 'head_conv_kernel', lambda *a: 'kernel')

    class Lib:
        conv2d = staticmethod(lambda *a, **kw: 'conv2d')
        conv3d = staticmethod(lambda *a, **kw: 'conv3d')
    monkeypatch.setattr(commons, 'F', Lib)


def _args(cin=256, cout=768, k=7, stride=1, padding=None, dtype=torch.bfloat16, device='cuda',
          wdtype=None, nd=2, x_grad=False, w_grad=False, bias=True):
    x = Like((4, cin) + (64,) * nd, dtype, device, x_grad)
    w = Like((cout, cin) + (k,) * nd, wdtype or dtype, device, w_grad)
    b = Like((cout,), wdtype or dtype, device) if bias else None
    return x, w, b, stride, k // 2 if padding is None else padding


def _call(**case):
    return head_conv(*_args(**case))


@pytest.mark.parametrize('case, route', [
    (dict(), 'kernel'),                                   # the flagship's fused heads
    (dict(cin=128, cout=384), 'kernel'),                  # U22's
    (dict(cin=64, cout=64), 'kernel'),                    # the refinement head's
    (dict(k=3, bias=False), 'kernel'),
    (dict(k=1), 'kernel'),
    (dict(stride=(1, 1), padding=(3, 3)), 'kernel'),
    (dict(x_grad=True, w_grad=True, no_grad=True), 'kernel'),
    (dict(dtype=torch.float32), 'conv2d'),                # fp32 and TF32
    (dict(dtype=torch.float16), 'conv2d'),
    (dict(wdtype=torch.float32), 'conv2d'),
    (dict(device='cpu'), 'conv2d'),
    (dict(stride=2), 'conv2d'),
    (dict(padding=0), 'conv2d'),
    (dict(k=9), 'kernel'),                                # any odd K
    (dict(k=4, padding=2), 'conv2d'),
    (dict(cin=96), 'conv2d'),
    (dict(cin=128, cout=32), 'conv2d'),
    (dict(cout=200), 'conv2d'),
    (dict(w_grad=True), 'conv2d'),                        # training keeps autograd
    (dict(x_grad=True), 'conv2d'),
    (dict(nd=3), 'conv3d'),                               # 3-D heads
    (dict(cin=0), 'conv2d'),
])
def test_dispatch_rule(routes, case, route):
    case = dict(case)
    with torch.set_grad_enabled(not case.pop('no_grad', False)):
        assert _call(**case) == route
        # the route is the kernel's own rule, and nothing else
        assert kernel_module.takes(*_args(**case)) == (route == 'kernel')


def test_library_counter_counts_library_calls_only(routes):
    """The library routes launch nothing: ``LAUNCHES`` stays as it was."""
    before = LAUNCHES.copy()
    routes = [_call(**case) for case in (dict(dtype=torch.float32), dict(device='cpu'),
                                         dict(nd=3))]
    assert routes == ['conv2d', 'conv2d', 'conv3d'] and LAUNCHES == before


def test_library_paths_are_conv_unchanged():
    before = LAUNCHES.copy()
    for dtype in (torch.float32, torch.bfloat16):
        x, wt, b = (t.to(dtype) for t in operands(5, 2, 64, 64, 7, 10, 13))
        assert torch.equal(head_conv(x, wt, b, 1, 3), F.conv2d(x, wt, b, padding=3))
        assert torch.equal(head_conv(x, wt, b, 2, 3), F.conv2d(x, wt, b, stride=2, padding=3))
    assert LAUNCHES == before
    for nd in (2, 3):
        torch.manual_seed(nd)
        head = ReadOut(16, 6, kernel_size=7, nd=nd).eval()
        x = torch.randn((1, 16) + (9,) * nd)
        with torch.no_grad():
            assert torch.equal(head(x), head.tail(head.block[0](x)))


def test_span_counts_the_route(routes):
    spans.reset()
    spans.enable()
    try:
        _call()
        _call(dtype=torch.float32, cout=384, cin=128)
        records = spans.collect()
    finally:
        spans.disable()
        spans.reset()
    assert [(r['name'], r['counts']) for r in records] == [
        ('cpn.head_conv', {'kernel': 1, 'cout': 768}),
        ('cpn.head_conv', {'kernel': 0, 'cout': 384})]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the head conv kernel has no CPU mode')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('batch, cin, cout, k, h, w', [
    (2, 256, 768, 7, 40, 72),     # the flagship's fused heads, ragged in both axes
    (1, 128, 384, 7, 33, 17),     # U22's fused heads
    (2, 64, 64, 7, 64, 48),       # the refinement head
    (1, 64, 192, 3, 5, 3),        # smaller than a tile
    (1, 64, 128, 9, 21, 30),      # a K above the heads' 7
    (2, 128, 64, 1, 9, 17),       # no padding
    (4, 192, 576, 7, 512, 512),   # CpnConvNeXtLargeUNet's fused heads: BN 64, three depth steps
    (4, 192, 192, 7, 1024, 1024),  # its refinement head at full resolution
])
def test_kernel_matches_plain_on_card(card, batch, cin, cout, k, h, w):
    x, wt, b = (t.to(card) for t in operands(batch + cin + k, batch, cin, cout, k, h, w))
    before = LAUNCHES['cdt_head_conv']
    got = head_conv_kernel(x, wt, b)
    torch.cuda.synchronize()
    assert LAUNCHES['cdt_head_conv'] == before + 1
    assert got.shape == (batch, cout, h, w) and got.dtype == torch.bfloat16
    want = head_conv_plain(x, wt, b)   # rounded too: the two may differ by one ulp
    assert bool(within_rounding(got, want, cin * k * k, 2).all())
    zero = head_conv_kernel(torch.zeros_like(x), wt, b)
    assert torch.equal(zero, b[None, :, None, None].expand_as(zero))
    with pytest.raises(ValueError):
        kernel_module.head_conv_kernel(x.float(), wt, b)
    with pytest.raises(ValueError):    # F.conv2d takes no fp32 bias with bf16 operands
        kernel_module.head_conv_kernel(x, wt, b.float())


@pytest.mark.cuda
def test_kernel_on_empty_input_launches_nothing(card):
    x, wt, b = (t.to(card) for t in operands(7, 2, 64, 128, 7, 0, 16))
    before = LAUNCHES['cdt_head_conv']
    got = head_conv_kernel(x, wt, b)
    assert got.shape == (2, 128, 0, 16) and LAUNCHES['cdt_head_conv'] == before
