"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. There is no silent CPU path: with no card and no explicit
    device this raises, and `device="cpu"` is what the tests pass to run the
    kernels' plain versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lbmpc_tpu_torch runs on CUDA unless told otherwise, and no CUDA "
            "device is available; pass device='cpu' for the plain versions")
    return dev
