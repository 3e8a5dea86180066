from .common import normalize_adj_matrix
from .config import Config, ModelConfig
from .device import resolve_device
from .generic import slugify
from .logger import Logger
from .registry import ModelRegistry

__all__ = ["Config", "ModelConfig", "resolve_device", "slugify", "Logger",
           "ModelRegistry", "normalize_adj_matrix"]
