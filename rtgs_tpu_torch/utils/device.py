"""Where the port's constructors put their tensors."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``. Every public constructor of the
    port defaults to the card, as the JAX package puts its arrays on its
    default device; CUDA where there is none raises, so that no tensor
    lands on the CPU unasked (pass ``device="cpu"`` for that)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev}: CUDA is not available; pass "
                           "device='cpu' to build the tensors on the CPU")
    return dev
