"""Device resolution shared by every entry point of the port.

`device=None` means the CUDA card. There is no fallback: without a card
the default device raises, and only a caller that asks for the CPU
(`device="cpu"`) runs the plain PyTorch versions of the kernels there.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> `cuda`; otherwise `torch.device(device)`, which must be a
    CUDA device (present) or the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use cuda or cpu")
    return dev


def device_memory_bytes():
    """Total memory of the current CUDA card in bytes
    (`torch.cuda.get_device_properties(...).total_memory`), or None
    without one (the CPU). Never raises."""
    if not torch.cuda.is_available():
        return None
    return int(torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory)
