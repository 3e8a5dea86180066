from .losses import (inner_product, euclidean_distance, l2_distance, bpr_loss,
                     l2_loss, sigmoid_cross_entropy, square_loss, hinge_loss,
                     top1_loss, bpr_max_loss, top1_max_loss, info_nce_loss,
                     log_loss)
from .initializers import get_initializer, InitArg, torch_layer_default
from .metrics import (METRIC2ID, ID2METRIC, ranking_metrics_from_hits,
                      topk_from_scores, masked_topk_indices, mask_items,
                      topk_scores_and_indices, eval_score_matrix_device,
                      eval_score_matrix_device_paged,
                      hits_against_padded_truth)
from .sampling import (is_member_sorted, sample_negatives,
                       sample_negatives_weighted,
                       gumbel_topk_without_replacement)

# the graph names and these modules load on first use: ``ops.graph``
# imports ``skrx_torch.parallel``, which imports the kernels under this
# package, so an eager import here would be circular
_LAZY = {"Graph": "graph", "graph_from_sp_matrix": "graph",
         "propagate": "graph", "propagate_layers": "graph",
         "edge_dropout": "graph", "attention": None, "mm_graph": None,
         "optim": None, "rnn": None}

__all__ = [
    "inner_product", "euclidean_distance", "l2_distance", "bpr_loss",
    "l2_loss", "sigmoid_cross_entropy", "square_loss", "hinge_loss",
    "top1_loss", "bpr_max_loss", "top1_max_loss", "info_nce_loss", "log_loss",
    "get_initializer", "InitArg", "torch_layer_default",
    "METRIC2ID", "ID2METRIC", "ranking_metrics_from_hits", "topk_from_scores",
    "masked_topk_indices", "mask_items", "topk_scores_and_indices",
    "eval_score_matrix_device", "eval_score_matrix_device_paged",
    "hits_against_padded_truth",
    "is_member_sorted", "sample_negatives", "sample_negatives_weighted",
    "gumbel_topk_without_replacement",
    "Graph", "graph_from_sp_matrix", "propagate", "propagate_layers",
    "edge_dropout",
    "attention", "mm_graph", "optim", "rnn",
]


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(name)
    import importlib
    module = importlib.import_module(f".{_LAZY[name] or name}", __name__)
    return module if _LAZY[name] is None else getattr(module, name)
