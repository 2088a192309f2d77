"""Device selection for the port's entry points."""
import torch

__all__ = ['resolve_device']


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; never a silent CPU run.

    Raises:
        RuntimeError: a CUDA device is asked for (explicitly or by default)
            and none is available.
    """
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; pass device="cpu" to run '
                           'on the CPU')
    return dev
