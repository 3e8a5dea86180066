"""Logger to stdout (with color) and to a file (colors stripped), flushed
after every message: the port's own copy of ``skrx.utils.logger``."""
import logging
import os
import re
import sys
from typing import Optional

__all__ = ["Logger"]

_ANSI_RE = re.compile(r"\x1b\[[0-9;]*m")


class _StripColorFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        if isinstance(record.msg, str):
            record.msg = _ANSI_RE.sub("", record.msg)
        return True


class Logger:
    """Logs to stdout and to ``filename`` (its directory is created); with
    ``filename`` None it writes nothing (the ranks of a mesh but rank 0)."""

    def __init__(self, filename: Optional[str]):
        self._logger = logging.getLogger(
            filename if filename is not None else f"skrx_torch.{id(self)}")
        self._logger.setLevel(logging.DEBUG)
        self._logger.propagate = False
        self._logger.handlers.clear()
        if filename is None:
            self._logger.addHandler(logging.NullHandler())
            return

        dirname = os.path.dirname(filename)
        if dirname:
            os.makedirs(dirname, exist_ok=True)

        formatter = logging.Formatter("%(message)s")
        fh = logging.FileHandler(filename, encoding="utf-8")
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(formatter)
        fh.addFilter(_StripColorFilter())
        self._logger.addHandler(fh)

        sh = logging.StreamHandler(sys.stdout)
        sh.setLevel(logging.DEBUG)
        sh.setFormatter(formatter)
        self._logger.addHandler(sh)

    def _log(self, level: int, msg, *args):
        self._logger.log(level, msg, *args)
        for handler in self._logger.handlers:
            handler.flush()

    def debug(self, msg, *args):
        self._log(logging.DEBUG, msg, *args)

    def info(self, msg, *args):
        self._log(logging.INFO, msg, *args)

    def warning(self, msg, *args):
        self._log(logging.WARNING, msg, *args)

    def error(self, msg, *args):
        self._log(logging.ERROR, msg, *args)

    def critical(self, msg, *args):
        self._log(logging.CRITICAL, msg, *args)
