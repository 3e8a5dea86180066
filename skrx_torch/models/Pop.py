"""Pop — popularity baseline: the port of ``skrx.models.Pop``.

An item's score is its number of training interactions (f32), the same for
every user. Nothing is trained: ``_train_epoch`` returns None, and
``fit()`` only evaluates. Every row of ``predict`` is the same (a
broadcast view, no copy), so the items of equal count tie across the whole
catalog; ranks follow (score descending, id ascending), as in the JAX
package.
"""
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..run_config import RunConfig
from ..utils import ModelConfig
from .base import TorchRecommender

__all__ = ["Pop", "PopConfig"]


class PopConfig(ModelConfig):
    epochs: int = 1
    early_stop: int = 0

    def _validate(self):
        if not (isinstance(self.epochs, int) and self.epochs >= 0):
            raise ValueError(f"invalid Pop config: {self}")


class Pop(TorchRecommender):
    def __init__(self, run_config: RunConfig, model_config: Dict,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(run_config, PopConfig(**model_config), device)
        pairs = self.dataset.train_data.to_user_item_pairs()
        counts = np.bincount(pairs[:, 1], minlength=self.num_items)
        self._scores = torch.as_tensor(counts.astype(np.float32),
                                       device=self.device)

    def _train_epoch(self, epoch: int) -> None:
        return None                       # nothing to train

    @torch.no_grad()
    def predict(self, users) -> torch.Tensor:
        """(B, N) f32: the item counts broadcast over the B users."""
        return self._scores[None, :].expand(len(users), -1)
