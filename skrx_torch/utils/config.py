"""Typed config system (the port's own copy of ``skrx.utils.config``).

* ``Config`` — ordered attribute namespace whose ``__init__`` consumes known
  keyword arguments (unknown ones are ignored, so one flat dict can feed a
  run config and a model config) and then runs ``_validate()``.
* ``ModelConfig`` — the base of each model's hyper-parameter config.

The CLI and ini overlays of the JAX package come with the CLI slice.
"""
from collections import OrderedDict
from typing import Any, List

__all__ = ["Config", "ModelConfig"]


class Config:
    """Ordered attribute namespace with post-init validation."""

    def __init__(self, **kwargs):
        self._ordered_keys: List[str] = []
        for key, value in kwargs.items():
            if not hasattr(type(self), key) and key not in self.__dict__:
                continue
            setattr(self, key, value)
        self._validate()

    def _validate(self):
        pass

    def __setattr__(self, key, value):
        if key != "_ordered_keys" and not key.startswith("_"):
            keys = self.__dict__.setdefault("_ordered_keys", [])
            if key not in keys:
                keys.append(key)
        super().__setattr__(key, value)

    def to_dict(self) -> "OrderedDict[str, Any]":
        """All public attributes (class defaults overridden by instance)."""
        out: "OrderedDict[str, Any]" = OrderedDict()
        for klass in reversed(type(self).__mro__):
            for key, value in vars(klass).items():
                if key.startswith("_") or callable(value) or isinstance(
                        value, (property, classmethod, staticmethod)):
                    continue
                out[key] = value
        for key in self.__dict__.get("_ordered_keys", []):
            out[key] = getattr(self, key)
        return out

    def to_string(self, sep: str = ", ") -> str:
        """``key=value`` pairs joined by ``sep`` (run-id slugs and the
        hyper-parameter block of a log)."""
        return sep.join(f"{k}={v}" for k, v in self.to_dict().items())

    def __str__(self):
        items = ", ".join(f"{k}={v!r}" for k, v in self.to_dict().items())
        return f"{type(self).__name__}({items})"

    __repr__ = __str__


class ModelConfig(Config):
    """Per-model hyper-parameter config. A model's config defines the
    classmethod ``param_space()``, its search grid, where the JAX package's
    does; the hyper-parameter search that reads it comes with the CLI
    slice."""
