"""Port parity: training the ConvNeXt family.

* One training forward and backward of a small ConvNeXt CPN against
  ``jax.grad`` on the same numpy-seeded weights, images and targets, with
  stochastic depth 0 and the same numpy dropout masks on both sides: the
  loss and each term within 1e-5 relative, each gradient within 1e-4 of its
  tensor's largest (the helpers and tolerances of
  ``tests/test_torch_port_train.py``);
* stochastic depth in train mode by its statistics, since flax's draws
  cannot be reproduced.
"""
import numpy as np
import pytest
import torch

from celldetection_tpu_torch.models import commons as tcommons
from celldetection_tpu_torch.models import convnext as tconvnext
from celldetection_tpu_torch.models import cpn as tcpn
from celldetection_tpu_torch.models import unet as tunet
from celldetection_tpu_torch.util import init_jax_variables, state_dict_from_jax
from test_torch_port_train import (_SharedDropout, _batch, _biases_before_norms,
                                   _jax_train_forward)
from test_torch_port_zoo import _convnext
from test_torch_port_cpn import one_torch_thread  # noqa: F401  (pytestmark)

pytestmark = pytest.mark.usefixtures('one_torch_thread')


def test_convnext_train_step_matches_jax():
    """One training forward and backward of a small ConvNeXt CPN (one input
    channel, 64^2, batch 2, K the score map's pixels) against ``jax.grad``."""
    size = 64
    jctor, pctor = _convnext(depths=(1, 1, 1, 1), channels=(8, 16, 24, 32))
    kw = dict(in_channels=1, max_detections=(size // 2) ** 2, samples=16)
    pm = pctor(device='cpu', **kw)
    variables = init_jax_variables(pm, 12)
    pm.load_state_dict(state_dict_from_jax(variables), strict=True)
    jm = jctor(**kw)
    x, targets = _batch(seed=12)
    dropout = _SharedDropout(12)
    j_loss, j_losses, j_grads, _ = _jax_train_forward(jm, variables, x, targets, dropout)
    dropout.hook_port(pm)
    pm.train()
    out = pm.forward_padded(torch.from_numpy(x),
                            targets={k: torch.from_numpy(v) for k, v in targets.items()},
                            generator=torch.Generator().manual_seed(0))
    out['loss'].backward()
    np.testing.assert_allclose(out['loss'].item(), j_loss, rtol=1e-5)
    for k, v in j_losses.items():
        np.testing.assert_allclose(out['losses'][k].item(), v, rtol=1e-5, err_msg=k)
    assert int(out['valid'].sum()) == int((out['dense_labels'] > 0).sum()) > 0
    want = state_dict_from_jax({'params': j_grads})
    got = {k: p.grad for k, p in pm.named_parameters()}
    assert sorted(got) == sorted(want)
    zero = _biases_before_norms(pm)
    assert any('body' in k for k in got) and 'core.backbone.body.stage0_block0.mlp0.weight' in got
    for key, g in got.items():
        assert g is not None and torch.isfinite(g).all(), key
        scale_key = key[:-len('bias')] + 'weight' if key in zero else key
        atol = 1e-4 * float(np.abs(want[scale_key].numpy()).max())
        np.testing.assert_allclose(g.numpy(), want[key].numpy(), rtol=0, atol=atol, err_msg=key)


def test_stochastic_depth_statistics():
    """A ConvNeXt block in train mode drops its whole branch per sample with
    its probability and scales the kept ones by ``1 / keep``; in eval mode
    it is the identity; the encoder's probabilities rise linearly to the
    last block's."""
    enc = tconvnext.ConvNeXtEncoder(in_channels=3, depths=(1, 1, 2, 1), channels=(8, 8, 8, 8),
                                    stochastic_depth_prob=0.4)
    probs = [m.drop.p for n, m in enc.named_modules() if isinstance(m, tconvnext.CNBlock)]
    np.testing.assert_allclose(probs, [0., 0.1, 0.2, 0.3, 0.4])
    block = tconvnext.CNBlock(8, layer_scale=1., stochastic_depth_prob=0.3)
    x = torch.randn(4000, 8, 3, 3)
    block.eval()
    with torch.no_grad():
        branch = block(x) - x
        block.train()
        block.drop.generator = torch.Generator().manual_seed(0)
        out = block(x) - x
    dropped = (out == 0).flatten(1).all(1)
    assert abs(float(dropped.float().mean()) - 0.3) < 0.03
    kept = ~dropped
    torch.testing.assert_close(out[kept], branch[kept] / 0.7, rtol=1e-5, atol=1e-6)
    # the CPN hands its generator to every stochastic-depth module, as to dropout
    pm = tcpn._make_cpn(tunet._backbone_unet(tconvnext.ConvNeXtTiny), 3,
                        dict(stochastic_depth_prob=0.1), device='cpu', torch_init=False)
    drops = [m for m in pm.core.modules() if isinstance(m, tcommons.StochasticDepth)]
    assert len(drops) == 18 and all(d in pm._dropouts for d in drops)
