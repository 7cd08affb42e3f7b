"""Device resolution for the port's entry points.

Entry points (`build`, `CHLIndex.load`, `graphs.device_arrays`) run on
the card unless the caller asks for another device. There is no silent
CPU fallback: without CUDA, a call that names no device raises.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; raises when CUDA is not available."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "path explicitly")
        return torch.device("cuda")
    return torch.device(device)


__all__ = ["DeviceLike", "resolve_device"]
