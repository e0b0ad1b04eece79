"""Explicit device set-up for the port.

The pose math (3x3 compositions, the 6x6 normal equations, Newton-Schulz
re-orthogonalization) must stay in full float32, as the JAX package forces
with `precision=HIGHEST`. On the card a float32 matmul is full precision by
default, but a float32 convolution goes through cuDNN in TF32 (about three
decimal digits) by default, and either default can be changed by the host
program. `resolve_device` pins both off before the port touches the card.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The torch device to run on: ``device`` if given, else the current CUDA
    device. There is no silent CPU default: without a card the caller must
    ask for ``device="cpu"`` (the plain PyTorch path) explicitly. TF32 is
    disabled for both matmuls and cuDNN convolutions (module docstring)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path explicitly"
        )
    return torch.device("cuda", torch.cuda.current_device())
