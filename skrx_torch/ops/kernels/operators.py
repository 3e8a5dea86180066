"""The kernels of the rank tail as PyTorch operators, ``torch.ops.skrx.*``.

``submax`` (#1), ``kth_largest`` (#2), ``extract`` (#3), ``pruned_merge``
(#4) and ``vmem_topk`` (#5: the pruned_merge kernel with tau = -inf) are
operators of one library, ``skrx``, so that ``torch.export`` records them
in a graph and a program loaded from that graph launches them. Each has:

- a "CPU" implementation: its plain PyTorch version from ``topk_blocks``;
- a "CUDA" implementation: it allocates the outputs, launches the kernel on
  the current stream (``runtime.launch``) and adds one to
  ``LAUNCHES[<kernel>]``, the one place where that count moves, so that a
  loaded program counts its launches too. It never runs the plain version:
  a build or launch failure raises;
- a fake implementation: empty outputs of the CUDA implementation's shapes
  and dtypes on the input's device, for tracing.

The wrappers in ``topk_blocks`` check the arguments and call these; the
dispatcher picks the implementation by the tensors' device.

The operators are defined with ``torch.library.Library`` and ``impl``, not
``torch.library.custom_op``: a ``custom_op`` wraps every call in a further
layer of Python on top of the dispatcher's own cost, and serving one user
is bound by the host (each operator already adds several µs of host time
a call; ``experiments/host_call_times.py`` measures it). Registration is
Python only: nothing is compiled and ``triton`` is not imported here; a
kernel is built at its first CUDA launch (``_build.load``). Importing
``skrx_torch`` registers the library.
"""
from typing import Optional, Tuple

import torch

from .runtime import LAUNCHES, launch as _launch
from .topk_blocks import (GROUPS, extract_plain, kth_largest_plain,
                          pruned_merge_plain, submax_plain)

__all__ = ["OPERATORS"]

# operator -> its schema; the same names as the wrappers and the kernels
OPERATORS = {
    "submax": "submax(Tensor scores, Tensor? mask_table, int block_n) "
              "-> Tensor",
    "kth_largest": "kth_largest(Tensor vals, int k) -> Tensor",
    "extract": "extract(Tensor scores, Tensor tau, int k, Tensor? "
               "mask_table, int block_n) -> (Tensor, Tensor)",
    "pruned_merge": "pruned_merge(Tensor vals, Tensor idx, int k, "
                    "Tensor tau) -> (Tensor, Tensor)",
    "vmem_topk": "vmem_topk(Tensor vals, Tensor idx, int k) "
                 "-> (Tensor, Tensor)",
}

_lib = torch.library.Library("skrx", "DEF")
for _schema in OPERATORS.values():
    _lib.define(_schema)


def _mask_width(mask_table: Optional[torch.Tensor]) -> int:
    return 0 if mask_table is None else mask_table.shape[1]


def _contiguous(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.contiguous()


def _neg_inf_tau(vals: torch.Tensor) -> torch.Tensor:
    return torch.full((vals.shape[0],), float("-inf"), device=vals.device)


# ------------------------------------------------------------- output shapes

def _submax_out(scores, block_n):
    b, n = scores.shape
    return scores.new_empty((b, -(-n // block_n) * GROUPS))


def _extract_out(scores, k, block_n):
    b, n = scores.shape
    w = -(-n // block_n) * k
    return (scores.new_empty((b, w)),
            scores.new_empty((b, w), dtype=torch.int32))


def _merge_out(vals, k):
    b = vals.shape[0]
    return vals.new_empty((b, k)), vals.new_empty((b, k), dtype=torch.int32)


# ------------------------------------------------------------- CUDA

def _submax_cuda(scores: torch.Tensor, mask_table: Optional[torch.Tensor],
                 block_n: int) -> torch.Tensor:
    scores, mask_table = scores.contiguous(), _contiguous(mask_table)
    out = _submax_out(scores, block_n)
    b, n = scores.shape
    if b:
        _launch("skrx_submax", scores.device, scores, b, n, block_n,
                mask_table, _mask_width(mask_table), out)
        LAUNCHES["submax"] += 1
    return out


def _kth_largest_cuda(vals: torch.Tensor, k: int) -> torch.Tensor:
    vals = vals.contiguous()
    b, w = vals.shape
    out = vals.new_empty((b,))
    if b:
        _launch("skrx_kth_largest", vals.device, vals, b, w, k, out)
        LAUNCHES["kth_largest"] += 1
    return out


def _extract_cuda(scores: torch.Tensor, tau: torch.Tensor, k: int,
                  mask_table: Optional[torch.Tensor], block_n: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    scores, tau = scores.contiguous(), tau.contiguous()
    mask_table = _contiguous(mask_table)
    out_v, out_i = _extract_out(scores, k, block_n)
    b, n = scores.shape
    if b:
        _launch("skrx_extract", scores.device, scores, b, n, block_n,
                mask_table, _mask_width(mask_table), tau, k, out_v, out_i)
        LAUNCHES["extract"] += 1
    return out_v, out_i


def _merge_cuda(vals: torch.Tensor, idx: torch.Tensor, k: int,
                tau: torch.Tensor, kernel: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pruned_merge kernel, its launch counted as ``kernel``'s: #4
    (``pruned_merge``) or #5 (``vmem_topk``), the TPU kernel it stands
    for."""
    vals, idx, tau = vals.contiguous(), idx.contiguous(), tau.contiguous()
    out_v, out_i = _merge_out(vals, k)
    b, w = vals.shape
    if b:
        _launch("skrx_pruned_merge", vals.device, vals, idx, b, w, tau, k,
                out_v, out_i)
        LAUNCHES[kernel] += 1
    return out_v, out_i


def _pruned_merge_cuda(vals, idx, k, tau):
    return _merge_cuda(vals, idx, k, tau, "pruned_merge")


def _vmem_topk_cuda(vals, idx, k):
    return _merge_cuda(vals, idx, k, _neg_inf_tau(vals), "vmem_topk")


# ------------------------------------------------------------- CPU

def _vmem_topk_cpu(vals, idx, k):
    return pruned_merge_plain(vals, idx, k, _neg_inf_tau(vals))


# ------------------------------------------------------------- registration

_IMPLS = {
    "submax": (submax_plain, _submax_cuda,
               lambda scores, mask_table, block_n:
               _submax_out(scores, block_n)),
    "kth_largest": (kth_largest_plain, _kth_largest_cuda,
                    lambda vals, k: vals.new_empty((vals.shape[0],))),
    "extract": (lambda scores, tau, k, mask_table, block_n: extract_plain(
                    scores, mask_table, tau, k, block_n), _extract_cuda,
                lambda scores, tau, k, mask_table, block_n:
                _extract_out(scores, k, block_n)),
    "pruned_merge": (pruned_merge_plain, _pruned_merge_cuda,
                     lambda vals, idx, k, tau: _merge_out(vals, k)),
    "vmem_topk": (_vmem_topk_cpu, _vmem_topk_cuda,
                  lambda vals, idx, k: _merge_out(vals, k)),
}

for _name, (_cpu, _cuda, _fake) in _IMPLS.items():
    _lib.impl(_name, _cpu, "CPU")
    _lib.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"skrx::{_name}", _fake, lib=_lib)
