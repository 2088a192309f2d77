"""Seeded random weights for a configuration, made on the device in a few large calls.

The rule of the port's ``util/weights.py: init_jax_variables``, kept here as
the benchmark's own so that the program and the reference get the very same
weights from ``--seed``: convolution kernels He-uniform (``U(-b, b)``,
``b = sqrt(6 / fan_in)``), which keeps the activations' scale through ReLU
stacks; norm scales and running variances ``U(0.5, 1.5)``; biases and
running means ``0.1 N(0, 1)``. A configuration's ``weight_factors`` then
scale named leaves (``[regex, factor]`` pairs), as ``chip_smoke.py``'s
``tame`` does for deep residual encoders, whose random activations
otherwise grow block by block until the score sigmoid saturates.

In that order: the default draw of every leaf; then a configuration's own
initialiser (its reference's ``init_weights``, passed here as ``init``),
which sets leaves in place from a generator of its own, seeded from the
seed, so that every leaf it leaves alone is the default's bit for bit; then
the factors, on what the initialiser set too.
"""
import math
import re

import numpy as np
import torch


def make_weights(shapes: dict, seed: int, device, factors=(), init=None) -> dict:
    """``{name: float32 tensor}`` for ``{name: shape}`` from one uniform and one
    normal draw; ``init(weights, gen)``, where given, sets leaves before the factors."""
    sizes = [math.prod(s) for s in shapes.values()]
    total = sum(sizes)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    uniform = torch.rand(total, generator=gen, device=device)
    normal = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        u, z = uniform[off:off + n], normal[off:off + n]
        if len(shape) >= 2:
            bound = math.sqrt(6.0 / math.prod(shape[1:]))
            t = (u * 2 - 1) * bound
        elif name.endswith(('.weight', '.running_var')):
            t = u + 0.5
        else:
            t = z * 0.1
        out[name] = t.reshape(shape)
        off += n
    if init is not None:
        own = torch.Generator(device=device)
        state = np.random.SeedSequence([int(seed), 29]).generate_state(1, np.uint64)
        own.manual_seed(int(state[0]))
        init(out, own)
    for pattern, factor in factors:
        rx = re.compile(pattern)
        for name in out:
            if rx.search(name):
                out[name] = out[name] * factor
    return out
