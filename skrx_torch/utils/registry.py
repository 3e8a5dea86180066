"""Model registry: import a model and its config class by name, the way
``skrx.utils.ModelRegistry`` does for the JAX package: the port's models
(``load_skrx_model``, alias ``load_skrec_model``) and user models from a
directory (``load_model_from_dir``, as the CLI does for
``unarchived_models/``). A loader returns False and prints why when it
finds no model; ``get_model`` raises KeyError for a name never
registered."""
import importlib
import importlib.util
import os
import sys
from typing import Dict, Optional, Tuple

__all__ = ["ModelRegistry"]


class ModelRegistry:
    def __init__(self):
        self._models: Dict[str, Tuple[type, type]] = {}

    def register_model(self, model_cls: type, config_cls: type,
                       name: Optional[str] = None) -> None:
        self._models[name or model_cls.__name__] = (model_cls, config_cls)

    def load_skrx_model(self, name: str) -> bool:
        """Import ``skrx_torch.models.<name>`` and register ``<name>`` /
        ``<name>Config``."""
        try:
            module = importlib.import_module(f"skrx_torch.models.{name}")
        except ModuleNotFoundError as err:
            print(f"skrx_torch has no model named '{name}': {err}",
                  file=sys.stderr)
            return False
        return self._register_from_module(module, name)

    load_skrec_model = load_skrx_model

    def load_model_from_dir(self, directory: str, name: str) -> bool:
        """Load ``<directory>/<name>.py`` or ``<directory>/<name>/
        __init__.py`` as a user model."""
        for path in (os.path.join(directory, f"{name}.py"),
                     os.path.join(directory, name, "__init__.py")):
            if os.path.isfile(path):
                spec = importlib.util.spec_from_file_location(
                    f"user_models.{name}", path)
                module = importlib.util.module_from_spec(spec)
                sys.modules[spec.name] = module
                spec.loader.exec_module(module)
                return self._register_from_module(module, name)
        print(f"no model file for '{name}' under '{directory}'",
              file=sys.stderr)
        return False

    def _register_from_module(self, module, name: str) -> bool:
        model_cls = getattr(module, name, None)
        config_cls = getattr(module, f"{name}Config", None)
        if model_cls is None or config_cls is None:
            print(f"module '{module.__name__}' must define '{name}' and "
                  f"'{name}Config'", file=sys.stderr)
            return False
        self.register_model(model_cls, config_cls, name)
        return True

    def get_model(self, name: str) -> Tuple[type, type]:
        if name not in self._models:
            raise KeyError(f"model {name!r} is not registered; "
                           f"available: {self.list_models()}")
        return self._models[name]

    def list_models(self):
        return sorted(self._models)
