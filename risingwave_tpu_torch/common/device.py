"""Where the port runs: the GPU unless the caller names another device."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU, which must then be present; the CPU is
    used only when the caller asks for it (as the tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU unless it is "
                "given device='cpu'")
        device = "cuda"
    return torch.device(device)
