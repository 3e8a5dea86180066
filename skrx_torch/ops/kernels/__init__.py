"""Hand-written CUDA kernels of the port (sources in ``csrc/``, built with
nvcc at first use), each with a plain PyTorch version beside it: the top-k
and rank kernels in ``topk_blocks``, graph propagation in ``segsum``, the
launch counts and the launch itself in ``runtime``."""
from .runtime import KERNELS, LAUNCHES, reset_launches
from .topk_blocks import (SENTINEL, blockwise_candidates, blockwise_topk,
                          kth_largest, pruned_merge, vmem_topk)

__all__ = ["KERNELS", "LAUNCHES", "SENTINEL", "blockwise_candidates",
           "blockwise_topk", "kth_largest", "pruned_merge", "reset_launches",
           "vmem_topk"]
