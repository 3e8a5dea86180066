"""Device resolution for the port's entry points.

Entry points run on ``cuda:<gpu_id>`` unless the caller passes a device
(``device="cpu"`` is how the tests run them). A CUDA device that is absent
raises: there is no silent fallback to the CPU.
"""
from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None,
                   gpu_id: Union[int, str] = 0) -> torch.device:
    """``device`` if given, else ``cuda:<gpu_id>``; raises RuntimeError when
    a CUDA device is asked for and is not there."""
    dev = torch.device(device if device is not None else f"cuda:{int(gpu_id)}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but CUDA is not available; pass "
                f"device='cpu' to run on the CPU")
        index = torch.cuda.current_device() if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"device {dev} requested but only "
                               f"{torch.cuda.device_count()} CUDA devices "
                               f"exist")
        dev = torch.device("cuda", index)
    elif dev.type != "cpu":
        raise RuntimeError(f"unsupported device {dev}")
    return dev
