"""Run-level configuration (the port's own copy of ``skrx.run_config``,
with the fields the serving slice reads; the JAX package's mesh, dtype,
evaluation and search options come with the slices that use them)."""
from typing import Union

from .utils.config import Config

__all__ = ["RunConfig"]

_VALID_COLUMNS = ("UI", "UIR", "UIT", "UIRT")


class RunConfig(Config):
    recommender: str = "BPRMF"
    data_dir: str = ""
    file_column: str = "UIRT"
    sep: str = "\t"
    # index of the CUDA device the entry points run on (cuda:<gpu_id>)
    gpu_id: Union[int, str] = 0
    seed: int = 2021

    def _validate(self):
        if not (isinstance(self.recommender, str) and self.recommender):
            raise ValueError("recommender must be a non-empty string")
        if not isinstance(self.data_dir, str):
            raise ValueError("data_dir must be a string")
        if self.file_column not in _VALID_COLUMNS:
            raise ValueError(f"file_column must be one of {_VALID_COLUMNS}")
        if int(self.gpu_id) < 0:
            raise ValueError("gpu_id must be >= 0")
        if not isinstance(self.seed, int):
            raise ValueError("seed must be an int")
