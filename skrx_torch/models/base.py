"""Base class of the port's models: run config, dataset and device.

The JAX package's fit harness, evaluator and logger wiring
(``skrx.models.base``) come with the training slice.
"""
from typing import Optional, Union

import torch
from torch import nn

from ..io import RSDataset
from ..run_config import RunConfig
from ..utils import Config, resolve_device

__all__ = ["TorchRecommender"]


class TorchRecommender(nn.Module):
    """Holds ``run_config``, ``dataset``, ``device`` (``cuda:<gpu_id>``
    unless ``device`` is given; absent CUDA raises) and the catalog size."""

    def __init__(self, run_config: RunConfig, model_config: Config,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        self.device = resolve_device(device, run_config.gpu_id)
        self.run_config = run_config
        self.config = model_config
        self.dataset = RSDataset(run_config.data_dir, run_config.sep,
                                 run_config.file_column)
        self.num_users = self.dataset.num_users
        self.num_items = self.dataset.num_items
