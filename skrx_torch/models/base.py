"""Base class of the port's models and the shared training harness: the
port of ``skrx.models.base`` (``AbstractRecommender`` and
``JaxRecommender`` in one).

A model holds its run config, dataset, device (``cuda:<gpu_id>`` unless
given; absent CUDA raises), logger (``log/<data>/<model>/<run_id>.log``
under the working directory) and ``RankingEvaluator``. ``fit()`` runs one
epoch at a time and evaluates every ``verbose`` epochs, stops early on
NDCG@10 after ``early_stop`` evaluations without a gain, and stops on a
non-finite loss. Subclasses implement ``_train_epoch(epoch) -> loss`` and
``predict``; a model trained by ``self.optimizer`` names in ``_JAX_PARAMS``
the parameters a JAX model of its kind carries over. Checkpoint and resume, the profiler trace and evaluation by
user group are not ported yet (ROADMAP.md, Queue 1).
"""
import os
import platform
import time
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..convert import adam_state_from_jax
from ..eval import EarlyStopping, MetricReport, RankingEvaluator
from ..io import RSDataset
from ..run_config import RunConfig
from ..utils import Config, Logger, resolve_device, slugify
from ..version import __version__

__all__ = ["TorchRecommender", "resolve_eval_batch_size"]


def resolve_eval_batch_size(batch_size: Union[int, str],
                            num_items: int) -> int:
    """``RunConfig.test_batch_size``: an int as given; "auto" the largest
    power of two whose (B, num_items) f32 score block stays under ~1 GB, in
    [64, 4096]."""
    if not isinstance(batch_size, str):
        return int(batch_size)
    budget_rows = (2 ** 30) // max(4 * num_items, 1)
    b = 64
    while b * 2 <= min(budget_rows, 4096):
        b *= 2
    return b


class TorchRecommender(nn.Module):
    _JAX_PARAMS: Tuple[str, ...] = ()

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
        self.logger = self._create_logger(self.dataset, model_config)
        # built here so that an eval_mode the port lacks fails before any
        # training epoch is spent
        self.evaluator = RankingEvaluator(
            self.dataset.train_data.to_user_dict(),
            self.dataset.test_data.to_user_dict(),
            metric=run_config.metric, top_k=run_config.top_k,
            batch_size=resolve_eval_batch_size(run_config.test_batch_size,
                                               self.num_items),
            num_thread=run_config.test_thread,
            eval_mode=run_config.eval_mode, device=self.device)
        # one entry per fit() epoch: epoch, loss, train_seconds and, where
        # it evaluated, eval_seconds and the MetricReport
        self.history: List[dict] = []

    def _create_logger(self, dataset: RSDataset, config: Config) -> Logger:
        model_name = self.__class__.__name__
        param_str = slugify(f"{dataset.data_name}_{model_name}_"
                            f"{config.to_string('_')}", max_len=155)
        run_id = f"{param_str}_{time.time():.8f}"
        data_tag = os.path.basename(os.path.normpath(dataset.data_dir))
        logger = Logger(os.path.join("log", data_tag, model_name,
                                     run_id + ".log"))
        logger.info(f"Server:\t{platform.node()}")
        logger.info(f"Workspace:\t{os.getcwd()}")
        logger.info(f"PID:\t{os.getpid()}")
        logger.info(f"skrx_torch version:\tv{__version__}")
        logger.info(f"Model:\t{self.__class__.__module__}")
        logger.info(f"Device:\t{self.device}")
        logger.info(f"\n{dataset.statistic_info}")
        logger.info(f"\nHyper-parameters:\n{config.to_string(chr(10))}\n")
        return logger

    def evaluate(self, test_users: Optional[Iterable[int]] = None
                 ) -> MetricReport:
        return self.evaluator.evaluate(self, test_users)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(self) -> MetricReport:
        """Train ``config.epochs`` epochs with per-epoch evaluation and early
        stopping; returns the best MetricReport (by NDCG@10)."""
        self.logger.info("metrics:".ljust(12)
                         + f"\t{self.evaluator.metrics_str}")
        early_stopping = EarlyStopping(metric="NDCG@10",
                                       patience=self.config.early_stop)
        eval_every = max(1, int(getattr(self.config, "verbose", 1)))
        epoch_start = time.perf_counter()
        for epoch in range(self.config.epochs):
            t0 = time.perf_counter()
            loss = self._train_epoch(epoch)
            self._sync()
            record = {"epoch": epoch, "loss": loss,
                      "train_seconds": time.perf_counter() - t0}
            self.history.append(record)
            if loss is not None and not np.isfinite(loss):
                self.logger.error(f"epoch {epoch}: non-finite loss ({loss}); "
                                  f"stopping")
                break
            if ((epoch + 1) % eval_every != 0
                    and epoch != self.config.epochs - 1):
                continue                  # the last epoch always evaluates
            t0 = time.perf_counter()
            cur_result = self.evaluate()
            record.update(eval_seconds=time.perf_counter() - t0,
                          report=cur_result)
            elapsed = time.perf_counter() - epoch_start
            epoch_start = time.perf_counter()
            loss_str = (f"loss={loss:.5f} [{elapsed:.2f}s]"
                        if loss is not None else "")
            self.logger.info(f"epoch {epoch}:".ljust(12)
                             + f"\t{cur_result.values_str}\t{loss_str}")
            if early_stopping(cur_result):
                self.logger.info("early stop")
                break
        self.logger.info("best:".ljust(12)
                         + f"\t{early_stopping.best_result.values_str}")
        return early_stopping.best_result

    def _train_epoch(self, epoch: int) -> Optional[float]:
        raise NotImplementedError

    def _copy_params(self, tensors: Dict[str, torch.Tensor]) -> None:
        """Copy CPU tensors into the parameters of the same names."""
        with torch.no_grad():
            for name, value in tensors.items():
                target = getattr(self, name)
                if target.shape != value.shape:
                    raise ValueError(f"{name}: shape {tuple(value.shape)}, "
                                     f"model has {tuple(target.shape)}")
                target.copy_(value)

    def load_jax_opt_state(self, count: int, mu: np.ndarray,
                           nu: np.ndarray) -> None:
        """Set the Adam state from the flat ``optax.adam`` state of a JAX
        model of this kind (``count`` and the raveled ``mu``, ``nu``)."""
        shapes = {name: tuple(getattr(self, name).shape)
                  for name in self._JAX_PARAMS}
        for name, state in adam_state_from_jax(count, mu, nu,
                                               shapes).items():
            param = getattr(self, name)
            self.optimizer.state[param] = {
                "step": state["step"],
                "exp_avg": state["exp_avg"].to(self.device),
                "exp_avg_sq": state["exp_avg_sq"].to(self.device)}

    def predict(self, users):
        raise NotImplementedError
