"""skrx_torch — the PyTorch/CUDA port of skrx.

Mirrors ``skrx``'s module names. Imports ``torch`` and never ``jax``, the
``skrx`` package or ``pandas``; its CUDA kernels are built from
``ops/kernels/csrc`` at first use. Entry points run on ``cuda:<gpu_id>``
unless the caller passes ``device="cpu"``.
"""
from .version import __version__
from .run_config import RunConfig
from .utils import Config, ModelConfig, ModelRegistry, resolve_device

__all__ = ["__version__", "RunConfig", "Config", "ModelConfig",
           "ModelRegistry", "resolve_device"]
