"""Model registry: import a port model and its config class by name, the
way ``skrx.utils.ModelRegistry`` does for the JAX package."""
import importlib
from typing import Dict, Optional, Tuple

__all__ = ["ModelRegistry"]


class ModelRegistry:
    def __init__(self):
        self._models: Dict[str, Tuple[type, type]] = {}

    def register_model(self, model_cls: type, config_cls: type,
                       name: Optional[str] = None) -> None:
        self._models[name or model_cls.__name__] = (model_cls, config_cls)

    def load_skrx_model(self, name: str) -> None:
        """Import ``skrx_torch.models.<name>`` and register ``<name>`` /
        ``<name>Config``; raises KeyError when the port has no such model."""
        try:
            module = importlib.import_module(f"skrx_torch.models.{name}")
        except ModuleNotFoundError as err:
            raise KeyError(f"skrx_torch has no model named {name!r}") from err
        model_cls = getattr(module, name, None)
        config_cls = getattr(module, f"{name}Config", None)
        if model_cls is None or config_cls is None:
            raise KeyError(f"module {module.__name__!r} must define {name!r} "
                           f"and {name + 'Config'!r}")
        self.register_model(model_cls, config_cls, name)

    def get_model(self, name: str) -> Tuple[type, type]:
        if name not in self._models:
            raise KeyError(f"model {name!r} is not registered; "
                           f"available: {self.list_models()}")
        return self._models[name]

    def list_models(self):
        return sorted(self._models)
