"""What every kernel wrapper of the port shares: the launch counts, the
ctypes signature of each C launcher in ``csrc/``, the launch itself on
PyTorch's current stream, the device and argument checks, and a step
captured in a CUDA graph (:class:`CapturedStep`) with its launches counted.

Each kernel's launch adds one to ``LAUNCHES[<kernel>]`` where it is made
and nowhere else (in its wrapper, or in the CUDA implementation of an
operator of ``operators``), so a run can show that its main path went
through the kernels. The counts move in Python: a wrapper called while a
graph is captured counts a launch that the capture records and does not
run, and a replay calls no wrapper. So :class:`CapturedStep` takes the
capture's counts back out and adds them once for each replay.
"""
import ctypes
from typing import Callable, Dict, Sequence

import torch

from . import _build

__all__ = ["KERNELS", "LAUNCHES", "reset_launches", "launch", "on_cuda",
           "check_device", "check", "CapturedStep", "WARMUP_STEPS"]

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


# calls of a step before its capture (on a side stream, as PyTorch's CUDA
# graphs ask): the first makes the lazy initialisations (the optimizer's
# state, the autograd engine's device thread, a C launcher's first-call
# set-up), the second runs as every later step does
WARMUP_STEPS = 2


class CapturedStep:
    """``step()``, a function of no arguments that reads and writes only
    tensors which stay in place, captured once in a CUDA graph on
    ``device``; :meth:`replay` launches it again.

    Before the capture every kernel of ``csrc/`` is built and loaded, and
    ``WARMUP_STEPS`` calls of ``step`` run on a side stream under
    ``torch.cuda.set_sync_debug_mode("error")``: a step that reads the
    device from the host raises there, since a graph cannot hold the read.
    The warm-up's launches are launches and count as such. Its effects are
    taken back after the capture: the tensors of ``keep`` get their values
    from before it, and ``generators`` their states, so that the first
    replay starts where the warm-up did. The ``generators`` are registered
    with the graph: each replay draws from where a generator's state then
    is and moves it on, as a call of ``step`` would.

    ``launches`` holds the launches the capture recorded (each wrapper
    counted one; none ran), taken back out of ``LAUNCHES``; each replay
    adds them. A failed capture or replay raises."""

    def __init__(self, step: Callable[[], None], device: torch.device,
                 keep: Sequence[torch.Tensor] = (),
                 generators: Sequence[torch.Generator] = ()):
        _build.load("segsum")                 # builds every source
        with torch.no_grad():
            saved = [t.clone() for t in keep]
        gen_states = [g.get_state() for g in generators]
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    step()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        current.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        before = dict(LAUNCHES)
        try:
            with torch.cuda.graph(self.graph):
                step()
        finally:
            self.launches = {k: LAUNCHES[k] - before[k] for k in KERNELS}
            LAUNCHES.update(before)
        with torch.no_grad():
            for t, value in zip(keep, saved):
                t.copy_(value)
        for g, state in zip(generators, gen_states):
            g.set_state(state)

    def replay(self) -> None:
        """Launch the captured step once; its launches counted."""
        self.graph.replay()
        for name, n in self.launches.items():
            LAUNCHES[name] += n
