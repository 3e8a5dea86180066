"""Phase 9 of ``chip_smoke.py`` at full depth (each kernel's device time
beside its bound, its plain version and a library call; the serving
latencies and busy shares; the training and evaluation times of the
models trained before it), for work on the times without the later
phases.

Usage, from the root of a checkout, on a machine with a card:

    python3 experiments/chip_phase9.py

Runs ``chip_smoke.main`` at ``chip_smoke.FULL_DEPTH`` (``REPS`` calls a
time, the script's depth before it was cut to half its time limit) with
phases 13-18 left out: phases 1-8 and 10-12 run with all their checks,
since phase 9 times their models and kernels at their shapes. Prints the
script's lines, its kernels line (launches of the phases run) and its last
line; exits 2 without CUDA.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_phase9: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    cs.full_depth()
    return cs.main(skip=(13, 14, 15, 16, 17, 18))


if __name__ == "__main__":
    sys.exit(main())
