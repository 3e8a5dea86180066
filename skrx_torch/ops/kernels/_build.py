"""Build the port's CUDA kernels with ``nvcc`` at first use and load them
with ``ctypes``.

Every ``csrc/*.cu`` file is compiled on its own into
``build/skrx_torch_kernels/lib<stem>-<hash>.so`` beside the package (the hash
is of the source, so an edited source is rebuilt), all ``nvcc`` processes
started together. Nothing here runs at import time: the first wrapper that
launches a kernel on a CUDA tensor calls :func:`load`.
"""
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

__all__ = ["load", "build_info", "BUILD_DIR", "NVCC_FLAGS"]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))), "build", "skrx_torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_info: Dict[str, object] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                       "built from source at first use")


def _target(src: str) -> str:
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:12]}.so")


def _build_all() -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for src in sorted(glob.glob(os.path.join(_CSRC, "*.cu"))):
        out = _target(src)
        stem = os.path.splitext(os.path.basename(src))[0]
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[stem] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    logs = {}
    for stem, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[stem] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {stem}.cu:\n{log}")
        os.replace(tmp, out)
    _info.update(seconds=time.perf_counter() - t0, built=sorted(procs),
                 log=logs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building every source on
    the first call."""
    with _lock:
        if not _libs:
            _build_all()
            for src in sorted(glob.glob(os.path.join(_CSRC, "*.cu"))):
                stem = os.path.splitext(os.path.basename(src))[0]
                _libs[stem] = ctypes.CDLL(_target(src))
        return _libs[name]


def build_info() -> Dict[str, object]:
    """Seconds the last build took, the sources it compiled and nvcc's
    output for each (ptxas register and shared-memory use)."""
    return dict(_info)
