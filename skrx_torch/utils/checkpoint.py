"""Training checkpoints and resume: the port of
``skrx.utils.checkpoint.Checkpointer`` on ``torch.save``.

A step is two files in the directory: ``step_<8 digits>.pt``, the state (a
dict of tensors and ``state_dict``s), and ``step_<8 digits>.extra.json``, the
trainer's scalars (epoch, early stopping). Each is written under a
temporary name and moved into place with ``os.replace``, so a crash never
leaves a truncated step that blocks a resume. The last ``keep`` steps are
kept. Epochs draw their batches from generators seeded by (seed, epoch), so
resuming at epoch k replays the rest of the schedule. JAX (orbax)
checkpoints are not read; ``skrx_torch.convert`` carries JAX state over.
"""
import json
import os
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

__all__ = ["Checkpointer"]

_STATE, _EXTRA = ".pt", ".extra.json"


def _replace_into(path: str, write) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, path)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 2):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._keep = keep

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step:08d}")

    def save(self, step: int, state: Dict[str, Any],
             extra: Optional[Dict] = None) -> None:
        """state: tensors and state_dicts (``torch.save``); extra: a dict of
        JSON values."""
        path = self._path(step)
        _replace_into(path + _STATE, lambda f: torch.save(state, f))
        if extra is not None:
            text = json.dumps(extra).encode()
            _replace_into(path + _EXTRA, lambda f: f.write(text))
        self._gc()

    def _steps(self) -> List[int]:
        out = []
        for name in os.listdir(self._dir):
            if name.startswith("step_") and name.endswith(_STATE):
                try:
                    out.append(int(name[len("step_"):-len(_STATE)]))
                except ValueError:
                    pass
        return sorted(out)

    def _gc(self) -> None:
        for step in self._steps()[:-self._keep]:
            for suffix in (_STATE, _EXTRA):
                try:
                    os.remove(self._path(step) + suffix)
                except FileNotFoundError:
                    pass

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None,
                map_location: Union[None, str, torch.device] = None
                ) -> Tuple[Optional[Dict[str, Any]], Dict, Optional[int]]:
        """``(state, extra, step)`` of ``step`` (default: the latest), its
        tensors loaded onto ``map_location``; ``(None, {}, None)`` when
        nothing was saved. A sidecar that fails to load gives ``extra ==
        {}`` (the state alone resumes; early stopping starts over)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, {}, None
        path = self._path(step)
        state = torch.load(path + _STATE, map_location=map_location,
                           weights_only=True)
        try:
            with open(path + _EXTRA, "rb") as f:
                extra = json.loads(f.read())
        except (OSError, ValueError):
            extra = {}
        return state, extra if isinstance(extra, dict) else {}, step
