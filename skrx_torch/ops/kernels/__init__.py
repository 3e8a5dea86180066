"""Hand-written CUDA kernels of the port (sources in ``csrc/``, built with
nvcc at first use), each with a plain PyTorch version beside it: the top-k
and rank kernels in ``topk_blocks``, fused score-and-select for dot models
in ``dot_topk`` (the module keeps its name: import ``dot_topk`` the function
from it), graph propagation in ``segsum``, the launch counts and the launch
itself in ``runtime``; ``operators`` registers the rank tail's kernels as
the PyTorch operators ``torch.ops.skrx.*``."""
from .dot_topk import (PackedItems, dot_topk_candidates, dot_topk_ranks,
                       pack_items)
from .runtime import KERNELS, LAUNCHES, reset_launches
from . import operators
from .topk_blocks import (SENTINEL, blockwise_candidates, blockwise_topk,
                          kth_largest, pruned_merge, rank_lookup_count,
                          vmem_topk)

__all__ = ["KERNELS", "LAUNCHES", "PackedItems", "SENTINEL",
           "blockwise_candidates", "blockwise_topk", "dot_topk_candidates",
           "dot_topk_ranks", "kth_largest", "pack_items", "pruned_merge",
           "rank_lookup_count", "reset_launches", "vmem_topk"]
