"""Hyper-parameter search driver: the port of
``skrx.utils.hyperopt_driver``.

``HyperOpt(run_config, model_class, config_class, fixed_params).run()``
fits one model when ``run_config.hyperopt`` is off or the config declares
no grid (``param_space()`` empty). Otherwise it searches the grid with the
search-level ``EarlyStopping("NDCG@10", patience=max(num_combos / 2,
10))``, each trial one ``model.fit()`` with ``fixed_params`` overlaid by
the trial's values, and returns the best trial's ``MetricReport``:

* through ``hyperopt.fmin`` (TPE, ``max_evals = num_combos``, an
  ``hp.choice`` a parameter) when the ``hyperopt`` library imports; the
  objective is -NDCG@10, and -10 + that once the early stopping fires,
  which ``early_stop_fn`` reads as the signal to stop;
* else over the whole grid in the order of ``random.Random(seed).shuffle``.

The log is ``log/<data>/<Model>/hyperopt_<data>_<Model>_<time>.log``: a
header, a TSV row a trial, the best parameters and results. ``device`` is
handed to every model built (``device="cpu"`` is how the tests run it;
None: ``cuda:<gpu_id>``).
"""
import itertools
import json
import os
import platform
import random
import time
from copy import deepcopy
from typing import Dict, Optional, Union

import torch

from ..eval import EarlyStopping, MetricReport
from ..io import RSDataset
from ..parallel.distributed import process_index
from ..run_config import RunConfig
from ..version import __version__
from .generic import slugify
from .logger import Logger

__all__ = ["HyperOpt"]


class HyperOpt:
    def __init__(self, run_config: RunConfig, model_class, config_class,
                 fixed_params: Dict,
                 device: Optional[Union[str, torch.device]] = None):
        run_config.hyperopt = bool(run_config.hyperopt
                                   and config_class.param_space())
        self._run_config = run_config
        self._model_class = model_class
        self._config_class = config_class
        self._fixed_params = fixed_params
        self._device = device
        self._current_model = None
        self._best_trial_str = None
        if not run_config.hyperopt:
            return
        try:
            from hyperopt import hp
            self._param_space = {key: hp.choice(key, values) for key, values
                                 in config_class.param_space().items()}
            self._have_hyperopt = True
        except ImportError:
            self._param_space = None
            self._have_hyperopt = False
        self._num_combos = config_class.num_combos()
        self._patience = max(int(self._num_combos / 2), 10)
        self._early_stopping = EarlyStopping(metric="NDCG@10",
                                             patience=self._patience)
        self._dataset = RSDataset(run_config.data_dir, run_config.sep,
                                  run_config.file_column)
        self.logger = self._create_logger()

    def _create_logger(self) -> Logger:
        param_str = slugify(f"{self._dataset.data_name}_"
                            f"{self._model_class.__name__}", max_len=155)
        run_id = f"hyperopt_{param_str}_{time.time():.8f}"
        data_tag = os.path.basename(os.path.normpath(self._dataset.data_dir))
        logger = Logger(os.path.join("log", data_tag,
                                     self._model_class.__name__,
                                     run_id + ".log")
                        if process_index() == 0 else None)
        logger.info("Task: Tune Hyper-Parameters")
        logger.info(f"Server:\t{platform.node()}")
        logger.info(f"Workspace:\t{os.getcwd()}")
        logger.info(f"PID:\t{os.getpid()}")
        logger.info(f"skrx_torch version:\tv{__version__}")
        logger.info(f"Model:\t{self._model_class.__module__}")
        logger.info(f"Dataset:\t{os.path.abspath(self._dataset.data_dir)}")
        logger.info("Hyper-Parameters Info:\t"
                    + json.dumps(self._config_class.param_space()))
        logger.info("")
        return logger

    @property
    def fixed_params(self) -> Dict:
        return deepcopy(self._fixed_params)

    def _build(self, params: Dict):
        self._current_model = self._model_class(self._run_config, params,
                                                device=self._device)
        return self._current_model

    def run(self) -> MetricReport:
        if not self._run_config.hyperopt:
            return self._build(self.fixed_params).fit()
        if not self._have_hyperopt:
            return self._run_grid_search()

        from hyperopt import Trials, fmin, tpe

        trials = Trials()
        self.logger.info(f"Early stopping patience:\t{self._patience}")
        self.logger.info(f"fmin max evals count:\t{self._num_combos}")
        # fmin's argmin is the stop-sentinel trial: the best is tracked by
        # the objective instead
        fmin(fn=self.objective, space=self._param_space, algo=tpe.suggest,
             max_evals=self._num_combos, trials=trials,
             early_stop_fn=self.early_stop_fn, verbose=False)
        self.logger.info("Best params:\t"
                         + json.dumps(getattr(self, "_best_params", {}),
                                      default=str))
        self.logger.info("\n\nBest results:")
        self.logger.info(str(self._best_trial_str))
        self.logger.info("\nDetailed results:\n"
                         + json.dumps(self._early_stopping.best_result.results,
                                      default=str))
        return self._early_stopping.best_result

    def _run_grid_search(self) -> MetricReport:
        """The whole grid in a seeded shuffled order, with the same early
        stopping: the search without the hyperopt library."""
        space = self._config_class.param_space()
        keys = list(space)
        combos = list(itertools.product(*(space[k] for k in keys)))
        random.Random(self._run_config.seed).shuffle(combos)
        self.logger.info(f"hyperopt library unavailable; grid search over "
                         f"{len(combos)} combos")
        best_params = None
        for tid, combo in enumerate(combos):
            params = self.fixed_params
            params.update(dict(zip(keys, combo)))
            result = self._build(params).fit()
            score = result[self._early_stopping.key_metric]
            self.logger.info(f"trial {tid}\t{dict(zip(keys, combo))}\t"
                             f"{self._early_stopping.key_metric}={score:.6f}")
            stopped = self._early_stopping(result)
            if self._early_stopping.best_result is result:
                best_params = dict(zip(keys, combo))
            if stopped:
                self.logger.info("search early stop")
                break
        self.logger.info("Best params:\t"
                         + json.dumps(best_params, default=str))
        self.logger.info("\nDetailed results:\n" + json.dumps(
            self._early_stopping.best_result.results, default=str))
        return self._early_stopping.best_result

    def objective(self, hp_params) -> float:
        model_params = self.fixed_params
        model_params.update(hp_params)
        result = self._build(model_params).fit()
        loss = -result[self._early_stopping.key_metric]
        prev_best = self._early_stopping.best_result
        stop = self._early_stopping(result)
        if self._early_stopping.best_result is not prev_best \
                or getattr(self, "_best_params", None) is None:
            self._best_params = dict(hp_params)
        if stop:
            return -10.0 + loss       # below any reachable metric: stop
        return loss

    def early_stop_fn(self, trials):
        latest = trials.trials[-1]
        if len(trials.trials) == 1:
            self.logger.info(self._trial2title(latest))
        self.logger.info(self._trial2value(latest))
        stopped = latest["result"]["loss"] < -1.01
        if not stopped:
            self._best_trial_str = self._trial2value(trials.best_trial)
        return stopped, []

    def _real_params(self, trial: Dict) -> Dict:
        from hyperopt import space_eval

        vals = trial["misc"]["vals"]
        return space_eval(self._param_space,
                          {k: v[0] for k, v in vals.items() if v})

    def _trial2title(self, trial: Dict) -> str:
        titles = (["tid"] + list(self._real_params(trial))
                  + ["loss", "book_time", "refresh_time"])
        return "\t".join(f"{v}".ljust(20) for v in titles)

    def _trial2value(self, trial: Dict) -> str:
        values = ([trial["tid"]] + list(self._real_params(trial).values())
                  + [trial["result"]["loss"], trial["book_time"],
                     trial["refresh_time"]])
        return "\t".join(f"{v}".ljust(20) for v in values)
