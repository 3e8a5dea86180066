from .common import build_ui_adjacency, normalize_adj_matrix, sp_mat_to_edges
from .config import (Config, ModelConfig, merge_config_with_cmd_args,
                     merge_config_with_ini, parse_value)
from .decorator import timer, typeassert
from .device import resolve_device
from .generic import OrderedDefaultDict, md5sum, pad_sequences, slugify
from .logger import Logger
from .random import (batch_randint_choice, host_rng, randint_choice,
                     set_host_seed)
from .registry import ModelRegistry

__all__ = ["Config", "ModelConfig", "merge_config_with_cmd_args",
           "merge_config_with_ini", "parse_value", "timer", "typeassert",
           "resolve_device", "OrderedDefaultDict", "md5sum", "slugify",
           "Logger", "ModelRegistry", "normalize_adj_matrix",
           "sp_mat_to_edges", "build_ui_adjacency",
           "pad_sequences", "randint_choice", "batch_randint_choice",
           "set_host_seed", "host_rng"]
