"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: the caller's, else the CUDA card.

    With no device given and no CUDA device present this raises instead
    of running on the CPU: the port's speed and its kernels exist only on
    the card, so a silent CPU run would measure and test the wrong thing.
    Pass `device="cpu"` to run the plain PyTorch versions deliberately.
    """
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            # 'cuda' and 'cuda:<current>' must compare equal
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; mobileposer_tpu_torch runs on the GPU "
            "by default. Pass device='cpu' to run the plain PyTorch "
            "versions of the kernels on the CPU.")
    return torch.device("cuda", torch.cuda.current_device())
