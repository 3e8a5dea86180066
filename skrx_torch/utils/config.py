"""Typed config system (the port's own copy of ``skrx.utils.config``).

* ``Config`` — ordered attribute namespace whose ``__init__`` consumes known
  keyword arguments (unknown ones are ignored, so one flat dict can feed a
  run config and a model config) and then runs ``_validate()``.
* ``ModelConfig`` — the base of each model's hyper-parameter config, with
  its search grid ``param_space()`` (empty: no search) and ``num_combos()``.
* ``merge_config_with_cmd_args`` / ``merge_config_with_ini`` — overlay
  ``--key value`` pairs and ini files; values are parsed by ``parse_value``
  (``ast.literal_eval``, never ``eval``, with a string fallback).
"""
import ast
import configparser
import sys
from collections import OrderedDict
from typing import Any, Dict, List, Optional

__all__ = ["Config", "ModelConfig", "merge_config_with_cmd_args",
           "merge_config_with_ini", "parse_value"]


def parse_value(text: str) -> Any:
    """A CLI or ini value as a Python literal, else the string itself;
    ``true`` and ``false`` in any case are bools (a string "false" would
    be truthy)."""
    if text.strip().lower() in ("true", "false"):
        return text.strip().lower() == "true"
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


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
    """Per-model hyper-parameter config with an optional search grid."""

    @classmethod
    def param_space(cls) -> Dict[str, list]:
        """The grid the search driver walks: parameter -> values. Empty
        disables the search."""
        return {}

    @classmethod
    def num_combos(cls) -> int:
        n = 1
        for values in cls.param_space().values():
            n *= max(len(values), 1)
        return n


def merge_config_with_cmd_args(config: Dict[str, Any],
                               argv: Optional[List[str]] = None
                               ) -> Dict[str, Any]:
    """``config`` overlaid with the ``--key value`` pairs of ``argv``
    (``sys.argv[1:]`` when None); raises SyntaxError on an odd count or a
    key without ``--``."""
    args = sys.argv[1:] if argv is None else list(argv)
    if len(args) % 2 != 0:
        raise SyntaxError("The numbers of arguments and values are not "
                          "equal.")
    out = dict(config)
    for flag, value in zip(args[0::2], args[1::2]):
        if not flag.startswith("--"):
            raise SyntaxError(f"Arguments must start with '--': {flag!r}")
        out[flag[2:]] = parse_value(value)
    return out


def merge_config_with_ini(config: Dict[str, Any], ini_path: str,
                          sections: Optional[List[str]] = None
                          ) -> Dict[str, Any]:
    """``config`` overlaid with the keys of an ini file, every section in
    file order unless ``sections`` names some; raises FileNotFoundError
    when the file cannot be read."""
    parser = configparser.ConfigParser()
    if not parser.read(ini_path):
        raise FileNotFoundError(ini_path)
    out = dict(config)
    for section in (sections if sections is not None
                    else parser.sections()):
        for key, value in parser.items(section):
            out[key] = parse_value(value)
    return out
