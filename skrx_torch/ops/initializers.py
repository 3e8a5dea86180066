"""Parameter initializers drawn from an explicit ``torch.Generator``.

The names and constants of ``skrx.ops.initializers``: normal and truncated
normal with sigma 0.01 (truncated at 2 sigma), uniform in [-0.05, 0.05],
He and Xavier (Glorot) variance scaling as ``jax.nn.initializers`` defines
them (truncated-normal or uniform; fans from the last two axes, the leading
axes a receptive field), zeros and ones. The draws are not the JAX package's
bits: JAX keys and torch generators give different streams from one seed.
"""
import math
from typing import Callable, Dict, Optional, Sequence

import torch

__all__ = ["get_initializer", "InitArg", "torch_layer_default"]


class InitArg:
    MEAN = 0.0
    STDDEV = 0.01
    MIN_VAL = -0.05
    MAX_VAL = 0.05


# standard deviation of a standard normal truncated to (-2, 2)
_TRUNC_STD = 0.87962566103423978


def _truncated(shape, generator, dtype) -> torch.Tensor:
    out = torch.empty(shape, dtype=dtype)
    return torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                       generator=generator)


def _uniform_in(shape, generator, dtype, lo: float, hi: float):
    return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                       dtype=dtype)


def _normal(shape: Sequence[int], generator: Optional[torch.Generator],
            dtype=torch.float32) -> torch.Tensor:
    return InitArg.MEAN + InitArg.STDDEV * torch.randn(
        shape, generator=generator, dtype=dtype)


def _truncated_normal(shape, generator, dtype=torch.float32):
    return InitArg.MEAN + InitArg.STDDEV * _truncated(shape, generator, dtype)


def _uniform(shape, generator, dtype=torch.float32):
    return _uniform_in(shape, generator, dtype, InitArg.MIN_VAL,
                       InitArg.MAX_VAL)


def _zeros(shape, generator=None, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def _ones(shape, generator=None, dtype=torch.float32):
    return torch.ones(shape, dtype=dtype)


def _variance_scaling(scale: float, mode: str, distribution: str) -> Callable:
    """``jax.nn.initializers.variance_scaling(scale, mode, distribution)``
    with its default axes: fan_in = shape[-2], fan_out = shape[-1], each
    times the product of the leading axes."""
    def init(shape, generator, dtype=torch.float32):
        if len(shape) < 2:
            raise ValueError(f"{mode} scaling needs >= 2 dims, got {shape}")
        field = math.prod(shape[:-2])
        fan_in, fan_out = shape[-2] * field, shape[-1] * field
        var = scale / (fan_in if mode == "fan_in" else (fan_in + fan_out) / 2)
        if distribution == "uniform":
            lim = math.sqrt(3.0 * var)
            return _uniform_in(shape, generator, dtype, -lim, lim)
        return _truncated(shape, generator, dtype) * (math.sqrt(var)
                                                      / _TRUNC_STD)
    return init


_INITIALIZERS: Dict[str, Callable] = {
    "normal": _normal,
    "truncated_normal": _truncated_normal,
    "uniform": _uniform,
    "he_normal": _variance_scaling(2.0, "fan_in", "truncated_normal"),
    "he_uniform": _variance_scaling(2.0, "fan_in", "uniform"),
    "xavier_normal": _variance_scaling(1.0, "fan_avg", "truncated_normal"),
    "xavier_uniform": _variance_scaling(1.0, "fan_avg", "uniform"),
    "zeros": _zeros,
    "ones": _ones,
}


def torch_layer_default(shape: Sequence[int], fan_in: int,
                        generator: Optional[torch.Generator],
                        dtype=torch.float32) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the default init of
    ``nn.Linear`` and ``nn.Conv2d`` weights and biases."""
    bound = 1.0 / math.sqrt(fan_in)
    return _uniform_in(shape, generator, dtype, -bound, bound)


def get_initializer(init_method: str) -> Callable:
    """``init(shape, generator, dtype=torch.float32) -> CPU tensor``."""
    if init_method not in _INITIALIZERS:
        names = ", ".join(_INITIALIZERS)
        raise ValueError(f"'init_method' is invalid, must be one of '{names}'")
    return _INITIALIZERS[init_method]
