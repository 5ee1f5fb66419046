"""Device selection for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU by
passing ``device="cpu"``.  Without a CUDA device they raise instead of
carrying on on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """Return the ``torch.device`` an entry point runs on.

    Args:
        device: ``None`` (the card), a device string or a ``torch.device``.
    Raises:
        RuntimeError: a CUDA device was asked for (explicitly or by
            default) and none is available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev
