"""skrx_torch — the PyTorch/CUDA port of skrx.

Mirrors ``skrx``'s module names. Imports ``torch`` and never ``jax``, the
``skrx`` package or ``pandas``; its CUDA kernels are built from
``ops/kernels/csrc`` at first use. Importing it registers the rank tail's
kernels as the operators ``torch.ops.skrx.*``, which a program exported by
``TopKRecommender.export_program`` calls. Entry points run on
``cuda:<gpu_id>`` unless the caller passes ``device="cpu"``.
"""
from .version import __version__
from .run_config import RunConfig
from . import utils
from . import io
from .utils import (Config, ModelConfig, ModelRegistry,
                    merge_config_with_cmd_args, merge_config_with_ini,
                    resolve_device)
from .ops.kernels import operators as _operators  # noqa: F401

__all__ = ["__version__", "RunConfig", "utils", "io", "Config",
           "ModelConfig", "ModelRegistry", "merge_config_with_cmd_args",
           "merge_config_with_ini", "resolve_device"]
