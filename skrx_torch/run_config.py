"""Run-level configuration: the port's own copy of ``skrx.run_config``,
with the same fields and defaults."""
from typing import Optional, Tuple, Union

from .utils.config import Config

__all__ = ["RunConfig"]

_VALID_COLUMNS = ("UI", "UIR", "UIT", "UIRT")
_VALID_METRICS = ("Precision", "Recall", "MAP", "NDCG", "MRR")
_EVAL_MODES = ("auto", "full", "chunked", "fused", "topk")


class RunConfig(Config):
    recommender: str = "BPRMF"
    data_dir: str = ""
    file_column: str = "UIRT"
    sep: str = "\t"
    # search the model config's param_space() (HyperOpt) instead of one fit
    hyperopt: bool = False
    # index of the CUDA device the entry points run on (cuda:<gpu_id>)
    gpu_id: Union[int, str] = 0
    metric: Tuple[str, ...] = ("Precision", "Recall", "MAP", "NDCG")
    top_k: Tuple[int, ...] = (10, 20, 30, 40, 50)
    # users per evaluation batch, or "auto": the largest power of two whose
    # (B, num_items) f32 score block stays under ~1 GB, in [64, 4096]
    test_batch_size: Union[int, str] = 64
    # kept for API parity with the JAX package; evaluation runs on the device
    test_thread: int = 4
    seed: int = 2021
    # mesh axis sizes (data, model); None or (1, 1): one process. A larger
    # mesh runs d * m ranks of one process each (torchrun, or
    # skrx_torch.parallel.run_ranks): batches split over data, tables over
    # model (BPRMF) or over every rank (LightGCN's graph)
    mesh_shape: Optional[Tuple[int, int]] = None
    # "float32" or "bfloat16": routed into a model config that declares a
    # compute_dtype field (MultVAE, SASRec, BERT4Rec) unless the model's
    # own config sets it; any other model warns and runs float32
    compute_dtype: str = "float32"
    # evaluation strategy: "full" scores the whole catalog per batch,
    # "chunked" eval_chunk_size items at a time (the (B, N) scores never
    # exist), "fused" ranks through the fused score-and-select kernels (dot
    # models); "auto" is "chunked" from eval_chunk_threshold items on, for
    # a model with predict_chunk, else "full"; "topk" ranks through the
    # model's predict_topk, the two-stage top-k over the catalog split by
    # the mesh's model axis, and is "auto"'s choice when that axis is above
    # 1. All produce the same metrics.
    eval_mode: str = "auto"
    eval_chunk_size: int = 65536
    eval_chunk_threshold: int = 131072
    # checkpoint and resume: fit() saves the parameters, the optimizer's
    # state and early stopping every checkpoint_every epochs under
    # <checkpoint_dir>/<model class>/ (0: never); resume=True starts fit()
    # after the latest checkpoint there
    checkpoint_dir: str = ""
    checkpoint_every: int = 0
    resume: bool = False
    # write a torch.profiler trace (CPU and CUDA activities) of one training
    # epoch and its evaluation to this directory; empty disables
    profile_dir: str = ""

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
        if isinstance(self.metric, str):
            self.metric = (self.metric,)
        self.metric = tuple(self.metric)
        for m in self.metric:
            if m not in _VALID_METRICS:
                raise ValueError(f"unknown metric {m!r}")
        if isinstance(self.top_k, int):
            self.top_k = (self.top_k,)
        self.top_k = tuple(int(k) for k in self.top_k)
        if not (self.top_k and all(k > 0 for k in self.top_k)):
            raise ValueError("top_k must hold positive ints")
        if isinstance(self.test_batch_size, str):
            if self.test_batch_size != "auto":
                raise ValueError("test_batch_size must be a positive int or "
                                 "'auto'")
        elif self.test_batch_size <= 0:
            raise ValueError("test_batch_size must be a positive int or "
                             "'auto'")
        if self.test_thread <= 0:
            raise ValueError("test_thread must be > 0")
        if self.eval_mode not in _EVAL_MODES:
            raise ValueError(f"eval_mode must be one of {_EVAL_MODES}")
        if not (self.eval_chunk_size > 0 and self.eval_chunk_threshold > 0):
            raise ValueError("eval_chunk_size and eval_chunk_threshold must "
                             "be > 0")
        if not (isinstance(self.checkpoint_dir, str)
                and isinstance(self.profile_dir, str)):
            raise ValueError("checkpoint_dir and profile_dir must be strings")
        if not (isinstance(self.checkpoint_every, int)
                and self.checkpoint_every >= 0):
            raise ValueError("checkpoint_every must be an int >= 0")
        if not isinstance(self.resume, bool):
            raise ValueError("resume must be a bool")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError("compute_dtype must be 'float32' or 'bfloat16'")
        if self.mesh_shape is not None:
            shape = tuple(self.mesh_shape)
            if len(shape) != 2 or not all(isinstance(a, int) and a > 0
                                          for a in shape):
                raise ValueError("mesh_shape must be None or two positive "
                                 "ints (data, model)")
            self.mesh_shape = shape
