"""What every kernel wrapper of the port shares: the launch counts, the
ctypes signature of each C launcher in ``csrc/``, the launch itself on
PyTorch's current stream, and the device and argument checks.

Each kernel's launch adds one to ``LAUNCHES[<kernel>]`` where it is made
and nowhere else (in its wrapper, or in the CUDA implementation of an
operator of ``operators``), so a run can show that its main path went
through the kernels.
"""
import ctypes
from typing import Dict

import torch

from . import _build

__all__ = ["KERNELS", "LAUNCHES", "reset_launches", "launch", "on_cuda",
           "check_device", "check"]

# kernel name -> its launches since the last reset; "vmem_topk" counts the
# pruned_merge kernel launched with tau = -inf (the TPU kernel #5)
KERNELS = ("submax", "kth_largest", "extract", "pruned_merge", "vmem_topk",
           "rank_count", "rank_lookup_count", "direct_rank", "dot_submax",
           "dot_extract", "segsum")
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int
# C launcher -> (source stem in csrc/, argument types before the stream)
_SIGNATURES = {
    "skrx_submax": ("topk_blocks", [_P, _I, _I, _I, _P, _I, _P]),
    "skrx_kth_largest": ("topk_blocks", [_P, _I, _I, _I, _P]),
    "skrx_extract": ("topk_blocks", [_P, _I, _I, _I, _P, _I, _P, _I, _P, _P]),
    "skrx_pruned_merge": ("topk_blocks", [_P, _P, _I, _I, _P, _I, _P, _P]),
    "skrx_rank_count": ("rank_counts", [_P, _P, _I, _I, _P, _P, _I, _P]),
    "skrx_rank_lookup_count": ("rank_counts", [_P, _P, _I, _I, _P, _I, _P,
                                               _P]),
    "skrx_direct_rank": ("rank_counts", [_P, _I, _I, _P, _I, _P, _I, _I, _P]),
    "skrx_dot_submax": ("dot_topk", [_P, _I, _I, _P, _P, _I, _I, _I, _P, _I,
                                     _P]),
    "skrx_dot_extract": ("dot_topk", [_P, _I, _I, _P, _P, _I, _I, _I, _P, _I,
                                      _P, _I, _P, _P]),
    "skrx_segsum": ("segsum", [_P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _P,
                               _P, _P, _P, _P, _P]),
}


def launch(fn_name: str, device: torch.device, *args) -> None:
    """Call the C launcher ``fn_name`` on ``device``'s current stream; a
    tensor argument passes its data pointer, None a null pointer. Raises
    when the launcher returns a CUDA error."""
    stem, argtypes = _SIGNATURES[fn_name]
    fn = getattr(_build.load(stem), fn_name)
    fn.argtypes = argtypes + [_P]           # the stream last
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(device).cuda_stream
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args]
    with torch.cuda.device(device):
        err = fn(*c_args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")


def check_device(*tensors) -> torch.device:
    """The device of the tensors (None entries skipped); raises on a mix or
    on a device that is neither the CPU nor CUDA."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors must share one device, got {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_cuda(*tensors) -> bool:
    """True for CUDA tensors, False for CPU ones; raises as
    :func:`check_device`."""
    return check_device(*tensors).type == "cuda"


def check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name} must be a {ndim}-D {dtype} tensor, got "
                         f"{t.dim()}-D {t.dtype}")
