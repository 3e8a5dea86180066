"""Hand-written CUDA kernels of the port (sources in ``csrc/``, built with
nvcc at first use), each with a plain PyTorch version beside it."""
from .topk_blocks import (LAUNCHES, SENTINEL, blockwise_candidates,
                          blockwise_topk, kth_largest, pruned_merge,
                          reset_launches, vmem_topk)

__all__ = ["LAUNCHES", "SENTINEL", "blockwise_candidates", "blockwise_topk",
           "kth_largest", "pruned_merge", "reset_launches", "vmem_topk"]
