"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

from typing import Optional, Union

import torch


class CudaUnavailableError(RuntimeError):
    """An entry point was asked to run on its default device (CUDA) on a
    machine where ``torch.cuda.is_available()`` is false. The port never
    falls back to the CPU on its own: pass ``device="cpu"`` to ask for
    the plain PyTorch path explicitly."""


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``None`` → the current CUDA device (or ``CudaUnavailableError``);
    anything else is taken as the caller's explicit choice."""
    if device is None:
        if not torch.cuda.is_available():
            raise CudaUnavailableError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise CudaUnavailableError(
                f"device {dev} requested but CUDA is unavailable"
            )
        if dev.index is None:  # "cuda" means the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
