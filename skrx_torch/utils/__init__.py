from .config import Config, ModelConfig
from .device import resolve_device
from .registry import ModelRegistry

__all__ = ["Config", "ModelConfig", "resolve_device", "ModelRegistry"]
