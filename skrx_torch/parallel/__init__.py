"""Meshes of ranks on ``torch.distributed``: the port of ``skrx.parallel``
(the (data, model) mesh and row ownership, the graph sharded over every
rank through kernel #11, the two-stage top-k over a split catalog through
kernels #1-#5, the data-parallel step's batch statistics, gathers and
gradient sums, and the process group)."""
from .distributed import (initialize_distributed, is_multi_host,
                          process_index, global_batch_from_local,
                          choose_backend, rank_device, run_ranks)
from .graph_shard import (ShardedGraph, sharded_graph_from_sp_matrix,
                          sharded_graph_from_coo, make_sharded_propagate,
                          ShardedPropGraph, pad_rows, unpad_rows)
from .mesh import (make_mesh, data_sharding, model_row_sharding, replicated,
                   shard_params_for_mf, mf_param_shardings,
                   model_parallel_size, DATA_AXIS, MODEL_AXIS, Mesh,
                   RowBlocks, take_rows, gather_rows, lookup_rows,
                   gather_all_rows)
from .batch import (data_parallel, active_mesh, batch_total, global_rows,
                    batch_mean, local_rows, gather_batch, gather_batch_ids,
                    batch_offset, once, sync_gradients, gather_whole)
from .topk_merge import (sharded_topk_scores, local_then_global_topk,
                         sharded_dot_topk)

__all__ = [
    "ShardedGraph", "sharded_graph_from_sp_matrix", "sharded_graph_from_coo",
    "make_sharded_propagate", "ShardedPropGraph", "pad_rows", "unpad_rows",
    "make_mesh", "data_sharding", "model_row_sharding", "replicated",
    "shard_params_for_mf", "mf_param_shardings", "model_parallel_size",
    "DATA_AXIS", "MODEL_AXIS", "Mesh", "RowBlocks", "take_rows",
    "gather_rows", "lookup_rows", "gather_all_rows", "sharded_topk_scores",
    "local_then_global_topk", "sharded_dot_topk", "initialize_distributed",
    "is_multi_host", "process_index", "global_batch_from_local",
    "choose_backend", "rank_device", "run_ranks", "data_parallel",
    "active_mesh", "batch_total", "global_rows", "batch_mean", "local_rows",
    "gather_batch", "gather_batch_ids", "batch_offset", "once",
    "sync_gradients", "gather_whole",
]
