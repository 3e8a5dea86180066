"""Base class of the port's models and the shared training harness: the
port of ``skrx.models.base`` (``AbstractRecommender`` and
``JaxRecommender`` in one).

A model holds its run config, dataset, device (``cuda:<gpu_id>`` unless
given; absent CUDA raises), logger (``log/<data>/<model>/<run_id>.log``
under the working directory), ``RankingEvaluator`` and user groups by
activity (``evaluate_group``). ``fit()`` runs one epoch at a time and
evaluates every ``verbose`` epochs, stops early on NDCG@10 after
``early_stop`` evaluations without a gain, and stops on a non-finite loss.
With ``RunConfig.checkpoint_dir`` and ``checkpoint_every`` it saves the
training state (``_train_state``: parameters, optimizer state) and early
stopping; ``resume`` restarts after the latest save. ``profile_dir``
writes a ``torch.profiler`` trace of epoch ``start + 1`` and its
evaluation. ``RunConfig.compute_dtype`` is routed into the model config as
in the JAX package. Predict caches are cleared after every epoch.

Subclasses implement ``_train_epoch(epoch) -> loss`` (None: nothing to
train) and ``predict``; a model trained by ``self.optimizer`` names in
``_JAX_PARAMS`` the parameters a JAX model of its kind carries over.

``RunConfig.mesh_shape`` (d, m) with ``d * m`` above 1 builds the mesh of
the started process group (one process a rank; ``make_mesh`` checks the
world size) and hands it to the evaluator and the model; every model
trains, evaluates and serves under it. Each rank trains on its data
index's rows of every batch inside a :func:`~skrx_torch.parallel.
data_parallel` block (``fit`` opens one around each training epoch), and
:meth:`sync_gradients` sums the gradients of its replicated parameters over
the data axis after each backward (``_GRAD_WHOLE`` names the parameters
whose gradient the backward's collectives already made whole, besides the
split tables; ``_GRAD_WORLD`` those applied to the rank's own node rows of
a sharded graph, summed over every rank). A rank holds its rows of a table
split over the ranks (``_row_blocks``; :meth:`whole_param` gathers one);
checkpoints hold the gathered whole tables and moments, as a
single-device run's, and resume takes each rank's rows again. Only rank 0
writes the log and the checkpoints; every rank runs every epoch,
evaluation and collective.
"""
import os
import platform
import time
import warnings
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..convert import adam_state_from_jax
from ..eval import (EarlyStopping, MetricReport, RankingEvaluator,
                    fused_family)
from ..io import RSDataset, group_users_by_interactions
from ..parallel import (RowBlocks, data_parallel, gather_rows, gather_whole,
                        lookup_rows, make_mesh, mf_param_shardings,
                        model_parallel_size, process_index, sync_gradients,
                        take_rows)
from ..run_config import RunConfig
from ..utils import Config, Logger, resolve_device, slugify
from ..utils.checkpoint import Checkpointer
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
    # under a mesh: the parameters (and their dotted children) whose
    # gradient the backward's collectives deliver whole, besides the tables
    # split over ranks, and those summed over every rank (applied to the
    # rank's own rows of a sharded graph); the rest sum over the data axis
    _GRAD_WHOLE: Tuple[str, ...] = ()
    _GRAD_WORLD: Tuple[str, ...] = ()

    def __init__(self, run_config: RunConfig, model_config: Config,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        self.device = resolve_device(device, run_config.gpu_id)
        self.mesh = None
        # parameter name -> its rows on this rank, for a table split over
        # the mesh's ranks (the others are whole on every rank)
        self._row_blocks: Dict[str, RowBlocks] = {}
        shape = run_config.mesh_shape
        if shape is not None and shape[0] * shape[1] > 1:
            self.mesh = make_mesh(shape, self.device)
        self.run_config = run_config
        self.config = model_config
        # the run's compute dtype reaches a model config that declares the
        # field (MultVAE, SASRec, BERT4Rec) unless the model config was
        # given its own; any other model warns and runs float32
        cdt = run_config.compute_dtype
        if cdt != "float32":
            if not hasattr(type(model_config), "compute_dtype"):
                warnings.warn(
                    f"RunConfig.compute_dtype={cdt!r} ignored: "
                    f"{type(model_config).__name__} declares no "
                    f"compute_dtype (no bfloat16 compute path); this model "
                    f"runs float32")
            elif "compute_dtype" not in model_config.__dict__:
                model_config.compute_dtype = cdt
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
            eval_mode=run_config.eval_mode,
            chunk_size=run_config.eval_chunk_size,
            chunk_threshold=run_config.eval_chunk_threshold,
            device=self.device, mesh=self.mesh)
        # likewise a forced strategy this model cannot serve
        mode = self.evaluator.eval_mode
        if ((mode == "chunked" and not hasattr(type(self), "predict_chunk"))
                or (mode == "fused" and fused_family(type(self)) is None)
                or (mode == "topk"
                    and not hasattr(type(self), "predict_topk"))):
            raise TypeError(f"eval_mode={mode!r} is not supported by "
                            f"{type(self).__name__} (its predict has no "
                            f"compatible factorization); use eval_mode="
                            f"'auto' or 'full'")
        self._user_groups = group_users_by_interactions(self.dataset)
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
                                     run_id + ".log")
                        if process_index() == 0 else None)
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

    def evaluate_group(self) -> List[Tuple[str, MetricReport]]:
        """``(label, report)`` for each user group by training activity
        (``group_users_by_interactions``)."""
        return [(g.label, self.evaluate(g.users)) for g in self._user_groups]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # derived predict state (propagated embeddings, user vectors), cleared
    # after every training epoch so that predict never serves stale state
    _PREDICT_CACHE_ATTRS = ("_final_emb", "_uv_cache")

    def _invalidate_predict_cache(self) -> None:
        for attr in self._PREDICT_CACHE_ATTRS:
            if getattr(self, attr, None) is not None:
                setattr(self, attr, None)

    def _checkpointer(self) -> Optional[Checkpointer]:
        rc = self.run_config
        if not rc.checkpoint_dir or rc.checkpoint_every <= 0:
            return None
        return Checkpointer(os.path.join(rc.checkpoint_dir,
                                         type(self).__name__))

    def full_params(self) -> Dict[str, torch.Tensor]:
        """The parameters as a single-device model holds them, detached: a
        table split over the mesh's ranks gathered whole (a collective
        call under a mesh)."""
        return {name: gather_rows(p.detach(), self._row_blocks.get(name))
                for name, p in self.named_parameters()}

    def _split_over_model_axis(self) -> None:
        """Under a mesh whose model axis is above 1, keep of each parameter
        split by :func:`~skrx_torch.parallel.mf_param_shardings` (a 2-D one
        of at least m rows) only this rank's rows (the tensor-parallel
        tables of the JAX package's ``_finalize_setup_flat``); called
        before the optimizer is made."""
        if model_parallel_size(self.mesh) <= 1:
            return
        params = dict(self.named_parameters())
        for name, blocks in mf_param_shardings(self.mesh, params).items():
            if blocks is None:
                continue
            owner, _, leaf = name.rpartition(".")
            module = self.get_submodule(owner) if owner else self
            setattr(module, leaf, nn.Parameter(
                take_rows(params[name].detach(), blocks)))
            self._row_blocks[name] = blocks

    def whole_param(self, name: str) -> torch.Tensor:
        """Parameter ``name`` whole: a table split over the mesh's ranks
        gathered (differentiable, a collective), any other as it is."""
        p = self.get_parameter(name)
        blocks = self._row_blocks.get(name)
        return p if blocks is None else gather_whole(p, blocks, self.mesh)

    @torch.no_grad()
    def eval_param(self, name: str) -> torch.Tensor:
        """Parameter ``name`` whole for scoring: a table split over the
        mesh's ranks gathered once (a collective) and kept while the
        parameter is the same tensor at the same version, any other as it
        is."""
        p = self.get_parameter(name)
        blocks = self._row_blocks.get(name)
        if blocks is None:
            return p
        cache = self.__dict__.setdefault("_whole_cache", {})
        hit = cache.get(name)
        if hit is None or hit[0] is not p or hit[1] != p._version:
            hit = cache[name] = (p, p._version, gather_rows(p.detach(),
                                                            blocks))
        return hit[2]

    def lookup(self, name: str, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` of parameter ``name`` for a training step: of a
        table split over the model axis through
        :func:`~skrx_torch.parallel.lookup_rows` (its backward sums the
        whole batch's gradient into the rank's rows), else indexed."""
        p = self.get_parameter(name)
        blocks = self._row_blocks.get(name)
        if blocks is None:
            return p[ids]
        return lookup_rows(p, ids, blocks, self.mesh)

    def sync_gradients(self) -> None:
        """Under a mesh, sum the gradients of the rank's parameters after a
        backward: over the data axis (with a model axis above 1 the mean
        over the model axis of every rank's sums, equal on every rank),
        the split tables and ``_GRAD_WHOLE`` skipped, ``_GRAD_WORLD`` over
        every rank (a no-op on one device)."""
        sync_gradients(self.named_parameters(), self.mesh,
                       (*self._row_blocks, *self._GRAD_WHOLE),
                       self._GRAD_WORLD)

    def _optimizer_state_rows(self, state_dict: Dict, rows) -> Dict:
        """``state_dict`` of ``self.optimizer`` with each moment of a split
        table mapped by ``rows(tensor, RowBlocks)`` (gather or take)."""
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        names = {id(p): n for n, p in self.named_parameters()}
        state = {}
        for i, st in state_dict["state"].items():
            blocks = self._row_blocks.get(names[id(params[i])])
            state[i] = {k: rows(v, blocks) if isinstance(v, torch.Tensor)
                        and v.dim() else v for k, v in st.items()}
        return {**state_dict, "state": state}

    def _train_state(self) -> Dict:
        """What a checkpoint holds: the parameters and the optimizer's
        state (split tables and their moments gathered whole); a model
        with more state across epochs extends it."""
        state: Dict = {"params": self.full_params()}
        optimizer = getattr(self, "optimizer", None)
        if optimizer is not None:
            state["optimizer"] = optimizer.state_dict()
            if self._row_blocks:
                state["optimizer"] = self._optimizer_state_rows(
                    state["optimizer"], gather_rows)
        return state

    def _load_train_state(self, state: Dict) -> None:
        self._copy_params(state["params"])
        if "optimizer" in state:
            opt_state = state["optimizer"]
            if self._row_blocks:
                opt_state = self._optimizer_state_rows(opt_state, take_rows)
            step = getattr(self, "train_step", None)
            if getattr(step, "state", None) is not None:
                # into the tensors a captured step holds
                step.load_state_dict(opt_state)
            else:
                self.optimizer.load_state_dict(opt_state)
        self._invalidate_predict_cache()

    def _start_trace(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_trace(self, prof, epoch: int) -> None:
        self._sync()
        prof.stop()
        profile_dir = self.run_config.profile_dir
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"{type(self).__name__}_epoch"
                            f"{epoch}_{os.getpid()}.trace.json")
        prof.export_chrome_trace(path)
        self.logger.info(f"profiler trace written to {path}")

    def fit(self) -> MetricReport:
        """Train ``config.epochs`` epochs with per-epoch evaluation and early
        stopping; returns the best MetricReport (by NDCG@10)."""
        self.logger.info("metrics:".ljust(12)
                         + f"\t{self.evaluator.metrics_str}")
        early_stopping = EarlyStopping(metric="NDCG@10",
                                       patience=self.config.early_stop)
        eval_every = max(1, int(getattr(self.config, "verbose", 1)))
        rc = self.run_config
        ckpt = self._checkpointer()
        start_epoch = 0
        if ckpt is not None and rc.resume:
            state, extra, step = ckpt.restore(map_location=self.device)
            if step is not None:
                self._load_train_state(state)
                early_stopping.set_state(extra.get("early_stopping", {}))
                start_epoch = extra.get("epoch", step) + 1
                self.logger.info(f"resumed from checkpoint at epoch {step}")

        def save(epoch):
            state = self._train_state()      # every rank: it gathers
            if process_index() == 0:
                ckpt.save(epoch, state,
                          {"epoch": epoch,
                           "early_stopping": early_stopping.get_state()})
            if self.mesh is not None:
                # no rank goes on (to a resume, say) before the file is
                # in place
                dist.barrier()

        prof = None
        epoch_start = time.perf_counter()
        try:
            for epoch in range(start_epoch, self.config.epochs):
                # the second epoch: the first pays for one-time set-up
                if rc.profile_dir and epoch == start_epoch + 1:
                    prof = self._start_trace()
                t0 = time.perf_counter()
                with data_parallel(self.mesh):
                    loss = self._train_epoch(epoch)
                self._sync()
                self._invalidate_predict_cache()
                record = {"epoch": epoch, "loss": loss,
                          "train_seconds": time.perf_counter() - t0}
                self.history.append(record)
                if loss is not None and not np.isfinite(loss):
                    self.logger.error(f"epoch {epoch}: non-finite loss "
                                      f"({loss}); stopping")
                    break
                skip_eval = ((epoch + 1) % eval_every != 0
                             and epoch != self.config.epochs - 1)
                if skip_eval:           # the last epoch always evaluates
                    if prof is not None:
                        self._stop_trace(prof, epoch)
                        prof = None
                    if ckpt is not None and \
                            (epoch + 1) % rc.checkpoint_every == 0:
                        save(epoch)
                    continue
                t0 = time.perf_counter()
                cur_result = self.evaluate()
                record.update(eval_seconds=time.perf_counter() - t0,
                              report=cur_result)
                if prof is not None:
                    self._stop_trace(prof, epoch)
                    prof = None
                elapsed = time.perf_counter() - epoch_start
                epoch_start = time.perf_counter()
                loss_str = (f"loss={loss:.5f} [{elapsed:.2f}s]"
                            if loss is not None else "")
                self.logger.info(f"epoch {epoch}:".ljust(12)
                                 + f"\t{cur_result.values_str}\t{loss_str}")
                stop = early_stopping(cur_result)
                if ckpt is not None and (epoch + 1) % rc.checkpoint_every == 0:
                    save(epoch)
                if stop:
                    self.logger.info("early stop")
                    break
        finally:
            if prof is not None:        # a stop or an error mid-trace
                prof.stop()
        self.logger.info("best:".ljust(12)
                         + f"\t{early_stopping.best_result.values_str}")
        return early_stopping.best_result

    def _train_epoch(self, epoch: int) -> Optional[float]:
        raise NotImplementedError

    def _copy_params(self, tensors: Dict[str, torch.Tensor]) -> None:
        """Copy CPU tensors into the parameters of the same names (dotted
        for a submodule's, as ``named_parameters`` gives them); of a table
        split over the mesh's ranks, the whole table, of which this rank
        takes its rows."""
        with torch.no_grad():
            for name, value in tensors.items():
                value = take_rows(value, self._row_blocks.get(name))
                target = self.get_parameter(name)
                if target.shape != value.shape:
                    raise ValueError(f"{name}: shape {tuple(value.shape)}, "
                                     f"model has {tuple(target.shape)}")
                target.copy_(value)

    def _jax_leaves(self) -> Dict[str, Tuple[str, bool]]:
        """Each leaf path of a JAX model of this kind's params (``q/0/w``)
        -> (the port's parameter name, transposed?); by default the names
        of ``_JAX_PARAMS``, untransposed."""
        return {name: (name, False) for name in self._JAX_PARAMS}

    def load_jax_opt_state(self, count: int, mu: np.ndarray,
                           nu: np.ndarray) -> None:
        """Set the Adam state from the flat ``optax.adam`` state of a JAX
        model of this kind (``count`` and the ``mu``, ``nu`` raveled in the
        order of its sorted leaf paths, :meth:`_jax_leaves`); a transposed
        leaf's moments are transposed as its parameter. A model with
        another optimizer overrides this."""
        leaves = self._jax_leaves()
        shapes = {}
        for key, (name, transposed) in leaves.items():
            shape = tuple(self.get_parameter(name).shape)
            if name in self._row_blocks:          # the whole table's
                shape = (self._row_blocks[name].num_rows, *shape[1:])
            shapes[key] = shape[::-1] if transposed else shape
        for key, state in adam_state_from_jax(count, mu, nu, shapes).items():
            name, transposed = leaves[key]
            if transposed:
                state = {k: v.T.contiguous() if v.dim() else v
                         for k, v in state.items()}
            state = {k: take_rows(v, self._row_blocks.get(name))
                     if v.dim() else v for k, v in state.items()}
            p = self.get_parameter(name)
            held = self.optimizer.state[p]
            if held:          # in place: a captured step holds the tensors
                with torch.no_grad():
                    for k, v in state.items():
                        held[k].copy_(v)
            else:
                # on a card Adam is capturable: its step count on the
                # device
                self.optimizer.state[p] = {k: v.to(self.device)
                                           for k, v in state.items()}

    def predict(self, users):
        raise NotImplementedError
