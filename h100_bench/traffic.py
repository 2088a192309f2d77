"""Inputs of the benchmark, made from ``--seed`` on the device.

``blob_mosaic`` follows ``scripts/bench_gigapixel.py``'s mosaic (as
``chip_smoke.py: blob_mosaic`` rewrote it in numpy): per block of 1024² px,
``disks`` disks of radius 8-22 px and intensity 0.4-0.9 over a faint noise
floor (0.03), here with every block drawn anew and three channels of fixed
gains, as 8-bit RGB. All disks go into the image in one ``scatter_reduce``.
"""
import numpy as np
import torch

CHANNEL_GAINS = (1.0, 0.85, 0.7)


def blob_mosaic(height: int, width: int, seed: int, device, block: int = 1024,
                disks: int = 160, radius=(8, 22), floor: float = 0.03) -> torch.Tensor:
    """``[height, width, 3]`` uint8 on ``device``; sides are multiples of ``block``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    nby, nbx = height // block, width // block
    n = nby * nbx * disks
    r = torch.randint(radius[0], radius[1], (n,), generator=gen, device=device)
    u = torch.rand(n, 2, generator=gen, device=device)
    level = 0.4 + 0.5 * torch.rand(n, generator=gen, device=device)
    img = torch.rand(height * width, generator=gen, device=device) * floor
    span = (block - 2 * r - 2).float()
    cy = (r + 1) + (u[:, 0] * span).long()
    cx = (r + 1) + (u[:, 1] * span).long()
    blk = torch.arange(n, device=device) // disks
    cy = cy + (blk // nbx) * block
    cx = cx + (blk % nbx) * block
    d = torch.arange(-radius[1], radius[1] + 1, device=device)
    dy, dx = torch.meshgrid(d, d, indexing='ij')
    dy, dx = dy.reshape(-1), dx.reshape(-1)
    inside = (dx[None] ** 2 + dy[None] ** 2) <= (r[:, None] ** 2)
    # taps outside a disk carry 0 and may land anywhere: clamp them into the image
    pos = (cy[:, None] + dy[None]) * width + (cx[:, None] + dx[None])
    pos = pos.clamp(0, height * width - 1)
    val = torch.where(inside, level[:, None], torch.zeros((), device=device))
    img = img.scatter_reduce(0, pos.reshape(-1), val.reshape(-1), 'amax')
    img = img.reshape(height, width)
    gains = torch.tensor(CHANNEL_GAINS, device=device)
    return (img[..., None] * gains * 255).round().clamp(0, 255).to(torch.uint8)


def crop_offsets(seed: int, count: int, batch: int, side: int, tile: int) -> np.ndarray:
    """``[count, batch, 2]`` (y, x) tile corners, uniform over a ``side``² pool."""
    rng = np.random.default_rng([int(seed), 7])
    return rng.integers(0, side - tile + 1, size=(count, batch, 2))
