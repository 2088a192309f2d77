"""The Mamba scan's fused kernel: ``kernels/selective_scan.py`` and its dispatch.

``selective_scan_plain`` repeats the kernel's chunked arithmetic (each chunk
of tokens scanned from a zero state, the states carried across the chunks,
each chunk scanned again from its carry-in); here it is held against a
float64 recurrence run token by token and against the torch scan of
``models/mamba.py: selective_scan``, at one token, fewer tokens than a chunk,
a ragged last chunk and several chunks, with Δ small and large. ``takes`` is
held on stand-ins that carry only what it reads, since this machine has no
card; the CPU keeps the torch scan. The tests marked ``cuda`` hold the kernel
against the float64 recurrence on the card (the Mamba CPN's four stage shapes
on a 1024² tile, batch 2, the strided operands the model passes, one token, no
image) and skip without one. The module imports neither JAX nor the JAX
package: ``python -m pytest --noconftest tests/test_torch_port_selective_scan.py
-m cuda`` runs it on a machine with a card.
"""
import functools
from dataclasses import dataclass

import numpy as np
import pytest
import torch

from celldetection_tpu_torch import models as tmodels
from celldetection_tpu_torch.kernels import LAUNCHES
from celldetection_tpu_torch.kernels.selective_scan import (chunk_tokens, exp2_plain,
                                                             selective_scan_kernel,
                                                             selective_scan_plain, takes)
from celldetection_tpu_torch.models import mamba as tmamba
from celldetection_tpu_torch.util import spans

pytestmark = pytest.mark.usefixtures('one_torch_thread')

# The Mamba CPN's scans on a 1024^2 tile (d_state 16, expand 2): tokens, d_inner a stage.
STAGES = ((65536, 512), (16384, 1024), (4096, 2048), (1024, 4096))


@pytest.fixture(scope='module')
def one_torch_thread():
    """One torch thread, as ``test_torch_port_cpn.py``'s fixture of that name."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def operands(seed, batch, tokens, d_inner, n=16, large=False, device='cpu'):
    """fp32 u, Δ, A, B, C, D. Δ small: log-uniform in [1e-3, 1e-1] (the range
    of the Mamba CPN's Δ at its initialisation), A near -(1 .. n) (its A_log);
    Δ large: 0.5 to 3.5 and A in [-1.1, -0.1], so the states forget within a
    few tokens."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=g, device=device)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device)
    if large:
        delta = rand(batch, tokens, d_inner) * 3 + .5
        A = -(rand(d_inner, n) + .1)
    else:
        delta = torch.exp(rand(batch, tokens, d_inner) * np.log(100.) + np.log(1e-3))
        A = -(torch.arange(1, n + 1, device=device, dtype=torch.float32) *
              (1 + .1 * rand(d_inner, n)))
    return (randn(batch, tokens, d_inner), delta, A, randn(batch, tokens, n),
            randn(batch, tokens, n), randn(d_inner))


def recurrence(u, delta, A, B, C, D, block=512):
    """The scan in float64, token by token from a zero state (the gains and
    drives of ``block`` tokens formed at a time, then one update a token)."""
    u, delta, A, B, C, D = (t.double() for t in (u, delta, A, B, C, D))
    batch, tokens, d_inner = u.shape
    s = u.new_zeros(batch, d_inner, A.shape[1])
    ys = []
    for t0 in range(0, tokens, block):
        dt = delta[:, t0:t0 + block]
        gain = torch.exp(dt[..., None] * A).transpose(0, 1).contiguous()   # [T, b, d, n]
        drive = ((dt * u[:, t0:t0 + block])[..., None] * B[:, t0:t0 + block, None, :]
                 ).transpose(0, 1).contiguous()
        states = torch.empty_like(gain)
        for i in range(gain.shape[0]):
            s = torch.addcmul(drive[i], gain[i], s, out=states[i])
        ys.append(torch.einsum('tbdn,btn->btd', states, C[:, t0:t0 + block]))
    return torch.cat(ys, 1) + u * D


def assert_close(got, want):
    """``|got - want| <= 1e-5 + 1e-4 |want|`` elementwise; returns the largest
    ``|got - want| / (1e-5 + 1e-4 |want|)``."""
    got, want = got.double().cpu(), want.double().cpu()
    assert got.shape == want.shape
    ratio = float(((got - want).abs() / (1e-5 + 1e-4 * want.abs())).max()) if got.numel() else 0.
    assert ratio <= 1., f'max |got - want| / (1e-5 + 1e-4 |want|) = {ratio:.3f}'
    return ratio


CASES = [(1, 32), (20, 32), (70, 32), (200, 32), (333, None)]   # tokens, chunk


@pytest.mark.parametrize('large', [False, True])
@pytest.mark.parametrize('tokens, chunk', CASES)
def test_plain_matches_the_recurrence(tokens, chunk, large):
    """One token, fewer than a chunk, a ragged last chunk, several chunks, and
    the default chunk (32 here: 11 chunks)."""
    args = operands(tokens, 2, tokens, 6, large=large)
    assert_close(selective_scan_plain(*args, chunk=chunk), recurrence(*args))


@pytest.mark.parametrize('large', [False, True])
@pytest.mark.parametrize('tokens, chunk', CASES)
def test_plain_matches_the_torch_scan(tokens, chunk, large):
    args = operands(tokens + 1, 2, tokens, 6, large=large)
    assert_close(selective_scan_plain(*args, chunk=chunk), tmamba.selective_scan(*args))


@pytest.mark.parametrize('n', [4, 8])
def test_plain_at_the_other_state_sizes(n):
    args = operands(n, 2, 100, 3, n=n)
    assert_close(selective_scan_plain(*args, chunk=32), recurrence(*args))


@pytest.mark.parametrize('low, high', [(-125., 0.), (-0.05, 0.), (-3., 3.)])
def test_exp2_plain_is_within_ulps_and_unbiased(low, high):
    """The kernel's 2^x (a polynomial on the FMA pipe) against float64: within
    1.5 fp32 ulp, and its mean relative error near 1 well below MUFU.EX2's
    -2.3e-8 (measured on the H100), which long-memory states drift with."""
    x = torch.linspace(low, high, 1_000_001, dtype=torch.float32)
    rel = exp2_plain(x).double() / torch.exp2(x.double()) - 1
    assert float(rel.abs().max()) <= 1.5 * 2. ** -23
    assert abs(float(rel.mean())) < 2e-9


def test_exp2_plain_floor():
    assert torch.equal(exp2_plain(torch.tensor([-125., -126., -1e4])),
                       torch.full((3,), 2. ** -125))
    assert torch.equal(exp2_plain(torch.tensor([0., -1., -7.])), torch.tensor([1., .5, 2. ** -7]))


def test_chunks_of_the_cell():
    """The Mamba CPN's stages on 1024^2 tiles: 1024 blocks of 128 channels each."""
    assert [chunk_tokens(1, L, D) for L, D in STAGES] == [256, 128, 64, 32]
    assert [chunk_tokens(2, L, D) for L, D in STAGES] == [512, 256, 128, 64]
    assert chunk_tokens(1, 1, 512) == chunk_tokens(3, 0, 8) == 32
    assert chunk_tokens(1, 2 ** 26, 8) == 2 ** 16        # at most 1024 chunks of 128 channels
    assert -(-2 ** 31 // chunk_tokens(1, 2 ** 31 - 1, 1)) <= 65535
    assert all(chunk_tokens(b, L, D) % 32 == 0 for b in (1, 5) for L in (1, 999, 70000)
               for D in (1, 300))


@dataclass
class Like:
    """What ``takes`` reads of a tensor, without a card."""
    shape: tuple
    dtype: torch.dtype = torch.float32
    device: str = 'cuda'
    requires_grad: bool = False

    @property
    def is_cuda(self):
        return self.device.startswith('cuda')

    def dim(self):
        return len(self.shape)


def _stand_ins(batch=1, tokens=65536, d_inner=512, n=16, **change):
    """u, Δ, A, B, C, D of the cell's first stage; ``change`` maps an
    operand's name to the fields it takes instead."""
    shapes = dict(u=(batch, tokens, d_inner), delta=(batch, tokens, d_inner), A=(d_inner, n),
                  B=(batch, tokens, n), C=(batch, tokens, n), D=(d_inner,))
    return [Like(**{'shape': shape, **change.get(name, {})}) for name, shape in shapes.items()]


@pytest.mark.parametrize('case, want', [
    (dict(), True),                                            # the cell's stage 1
    (dict(batch=2, tokens=1, d_inner=4096), True),
    (dict(batch=0), True),                                     # nothing to launch
    (dict(n=8), True),
    (dict(n=4), True),
    (dict(u=dict(requires_grad=True), D=dict(requires_grad=True), no_grad=True), True),
    (dict(u=dict(device='cpu'), delta=dict(device='cpu'), A=dict(device='cpu'),
          B=dict(device='cpu'), C=dict(device='cpu'), D=dict(device='cpu')), False),
    (dict(A=dict(device='cpu')), False),
    (dict(B=dict(device='cuda:1')), False),
    (dict(u=dict(dtype=torch.bfloat16), delta=dict(dtype=torch.bfloat16)), False),
    (dict(C=dict(dtype=torch.bfloat16)), False),
    (dict(D=dict(dtype=torch.float64)), False),
    (dict(D=dict(requires_grad=True)), False),                 # training keeps autograd
    (dict(u=dict(requires_grad=True)), False),
    (dict(delta=dict(shape=(1, 65536, 511))), False),          # shapes that do not match
    (dict(A=dict(shape=(512, 8))), False),
    (dict(A=dict(shape=(512,))), False),
    (dict(B=dict(shape=(1, 65535, 16))), False),
    (dict(C=dict(shape=(2, 65536, 16))), False),
    (dict(D=dict(shape=(1, 512))), False),
    (dict(u=dict(shape=(65536, 512))), False),
    (dict(n=32), False),
    (dict(n=12), False),
    (dict(batch=65536), False),
])
def test_takes(case, want):
    case = dict(case)
    with torch.set_grad_enabled(not case.pop('no_grad', False)):
        assert takes(*_stand_ins(**case)) is want


def test_cpu_keeps_the_torch_scan():
    """On the CPU ``selective_scan`` is the torch scan bit for bit, launches
    nothing and counts no ``kernel`` on its span; the kernel's wrapper raises."""
    args = operands(3, 2, 50, 4)
    before = LAUNCHES['cdt_selective_scan']
    a, b = tmamba.selective_scan(*args), tmamba.selective_scan(*args)
    assert torch.equal(a, b) and LAUNCHES['cdt_selective_scan'] == before
    with pytest.raises(ValueError):
        selective_scan_kernel(*args)
    model = tmodels.CpnResNet50UNet(3, max_detections=16, device='cpu', backbone_kwargs={
        'base_channel': 8, 'secondary_block': functools.partial(tmodels.MambaLayer,
                                                                 dt_rank='auto')}).eval()
    x = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    spans.reset()
    spans.enable()
    try:
        with torch.no_grad():
            model.forward_padded(x, score_thresh=0.5, nms=True)
        scans = [r for r in spans.collect() if r['name'] == 'mamba.scan']
    finally:
        spans.disable()
        spans.reset()
    assert len(scans) == 4 and all('kernel' not in r['counts'] for r in scans)
    assert LAUNCHES['cdt_selective_scan'] == before


def test_dispatch_counts_kernel_on_the_span(monkeypatch):
    """Where ``takes`` holds, ``selective_scan`` returns the kernel's result
    and counts ``kernel`` 1 on ``mamba.scan``; else the torch scan runs."""
    calls = []
    monkeypatch.setattr(tmamba, 'kernel_takes', lambda *a: calls.append('takes') or True)
    monkeypatch.setattr(tmamba, 'selective_scan_kernel', lambda u, *a: u * 2)
    m = tmamba.Mamba(8, d_state=16).eval()
    x = torch.randn(1, 10, 8, generator=torch.Generator().manual_seed(1))
    spans.reset()
    spans.enable()
    try:
        with torch.no_grad():
            m(x)
        recs = spans.collect()
    finally:
        spans.disable()
        spans.reset()
    assert calls == ['takes']
    assert [(r['name'], r['counts']['kernel']) for r in recs] == [('mamba.scan', 1)]
    u = torch.randn(1, 3, 4)
    assert torch.equal(tmamba.selective_scan(u, u, u[0].T, u, u, u[0, 0]), u * 2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the selective scan kernel has no CPU mode')
    return torch.device('cuda')


def _launch(args):
    before = LAUNCHES['cdt_selective_scan']
    with torch.no_grad():
        y = selective_scan_kernel(*args)
    torch.cuda.synchronize()
    assert LAUNCHES['cdt_selective_scan'] == before + 1
    assert y.dtype == torch.float32 and y.is_contiguous()
    return y


@pytest.mark.cuda
@pytest.mark.parametrize('tokens, d_inner', STAGES)
@pytest.mark.parametrize('large', [False, True])
def test_kernel_matches_the_recurrence_at_the_stages(card, tokens, d_inner, large):
    args = operands(tokens + large, 1, tokens, d_inner, large=large, device='cuda')
    assert_close(_launch(args), recurrence(*args))


@pytest.mark.cuda
@pytest.mark.parametrize('tokens, d_inner', [(4096, 2048), (1003, 300), (1, 512)])
def test_kernel_at_batch_two(card, tokens, d_inner):
    args = operands(tokens, 2, tokens, d_inner, device='cuda')
    y = _launch(args)
    assert_close(y, recurrence(*args))
    assert_close(y, selective_scan_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize('n', [4, 8, 16])
def test_kernel_on_the_operands_the_model_passes(card, n):
    """u a ``[B, L, D]`` view of a ``[B, D, L]`` tensor (the convolution's
    output transposed), B and C column slices of ``x_proj``'s output, A and D
    as ``Mamba`` passes them."""
    batch, tokens, d_inner, rank = 2, 3000, 640, 40
    g = torch.Generator(device='cuda').manual_seed(n)
    u = torch.randn(batch, d_inner, tokens, device='cuda', generator=g).transpose(1, 2)
    proj = torch.randn(batch, tokens, rank + 2 * n, device='cuda', generator=g)
    _, Bm, Cm = proj.split([rank, n, n], -1)
    delta = torch.rand(batch, tokens, d_inner, device='cuda', generator=g) * .1 + 1e-3
    m = tmamba.Mamba(d_inner // 2, d_state=n).to('cuda')
    args = (u, delta, -torch.exp(m.A_log.detach()), Bm, Cm, m.D.detach())
    assert u.stride() == (d_inner * tokens, 1, tokens) and Bm.stride()[1:] == (rank + 2 * n, 1)
    y = _launch(args)
    assert_close(y, recurrence(*args))
    with torch.no_grad():          # the model's route: the same launch
        assert torch.equal(tmamba.selective_scan(*args), y)


@pytest.mark.cuda
def test_kernel_on_one_token_and_no_image(card):
    args = operands(5, 3, 1, 700, device='cuda')
    assert_close(_launch(args), recurrence(*args))
    empty = [t[:0] if t.dim() == 3 else t for t in operands(6, 2, 10, 64, device='cuda')]
    before = LAUNCHES['cdt_selective_scan']
    y = selective_scan_kernel(*empty)
    assert y.shape == (0, 10, 64) and LAUNCHES['cdt_selective_scan'] == before


@pytest.mark.cuda
def test_kernel_raises_on_what_it_does_not_take(card):
    args = operands(7, 1, 64, 128, device='cuda')
    with pytest.raises(ValueError):
        selective_scan_kernel(*(t.bfloat16() for t in args))
    with pytest.raises(ValueError):
        selective_scan_kernel(*args[:2], args[2][:, :12], *args[3:])
    grad = [t.clone().requires_grad_() for t in args]
    with pytest.raises(ValueError):
        selective_scan_kernel(*grad)
    # the model's bf16 and training calls keep the torch scan
    before = LAUNCHES['cdt_selective_scan']
    tmamba.selective_scan(*(t.bfloat16() for t in args))
    tmamba.selective_scan(*grad).sum().backward()
    assert LAUNCHES['cdt_selective_scan'] == before
    assert takes(*args) and not takes(*grad)
