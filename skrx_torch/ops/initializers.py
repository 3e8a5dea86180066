"""Parameter initializers drawn from an explicit ``torch.Generator``.

The names and constants of ``skrx.ops.initializers`` that the ported models
use (normal with sigma 0.01, zeros). The draws are not the JAX package's
bits: JAX keys and torch generators give different streams from one seed.
"""
from typing import Callable, Dict, Optional, Sequence

import torch

__all__ = ["get_initializer", "InitArg"]


class InitArg:
    MEAN = 0.0
    STDDEV = 0.01


def _normal(shape: Sequence[int], generator: Optional[torch.Generator],
            dtype=torch.float32) -> torch.Tensor:
    return InitArg.MEAN + InitArg.STDDEV * torch.randn(
        shape, generator=generator, dtype=dtype)


def _zeros(shape: Sequence[int], generator: Optional[torch.Generator] = None,
           dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype)


_INITIALIZERS: Dict[str, Callable] = {"normal": _normal, "zeros": _zeros}


def get_initializer(init_method: str) -> Callable:
    """``init(shape, generator, dtype=torch.float32) -> CPU tensor``."""
    if init_method not in _INITIALIZERS:
        names = ", ".join(_INITIALIZERS)
        raise ValueError(f"'init_method' is invalid, must be one of '{names}'")
    return _INITIALIZERS[init_method]
