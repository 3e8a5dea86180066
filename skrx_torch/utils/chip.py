"""The card's published peaks, for bounds and roofline shares; the port's
counterpart of ``skrx.utils.chip``.

``PEAKS`` maps the name ``torch.cuda.get_device_name()`` gives to (bf16
matmul FLOP/s, f32 matmul FLOP/s, HBM bytes/s): NVIDIA's data sheet, dense
rates without sparsity, at the full power limit; f32 outside the tensor
cores, as the port runs its f32 matmuls without TF32. A card not in the
table raises: no rate is assumed for it.
"""
import subprocess
from typing import Tuple

__all__ = ["PEAKS", "chip_peaks", "card_line"]

PEAKS = {
    # H100 SXM5: 989 TFLOP/s bf16, 67 TFLOP/s f32, 80 GB HBM3 at 3.35 TB/s
    "NVIDIA H100 80GB HBM3": (989e12, 67e12, 3.35e12),
}


def chip_peaks(device: int = 0) -> Tuple[str, Tuple[float, float, float]]:
    """(name, (bf16 FLOP/s, f32 FLOP/s, HBM bytes/s)) of CUDA device
    ``device``; raises for a card not in :data:`PEAKS`."""
    import torch
    name = torch.cuda.get_device_name(device)
    if name not in PEAKS:
        raise KeyError(f"no published peaks for {name!r}; known: "
                       f"{sorted(PEAKS)}")
    return name, PEAKS[name]


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (the
    first card's line)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
