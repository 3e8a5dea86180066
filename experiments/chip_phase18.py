"""Phase 18 of ``chip_smoke.py`` alone (the long-run sweep's ten models,
cut, against the JAX reference at the same cut), for work on the sweep
without the other phases.

Usage, from the root of a checkout, on a machine with a card:

    python3 experiments/chip_phase18.py

Builds the kernels and runs ``chip_smoke.phase_longrun`` with all its
checks on the sweep's data under ``build/chip_phase18_data``; prints its
lines, the launches of its runs, the card's name and power limit and the
seconds taken. Exits 2 without CUDA.
"""
import os
import shutil
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_phase18: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from skrx_torch.ops.kernels import _build

    t0 = time.perf_counter()
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    _build.load("segsum")                 # builds every kernel
    print(f"kernels ready in {time.perf_counter() - t0:.1f} s", flush=True)
    root = os.path.join(ROOT, "build", "chip_phase18_data")
    runs = cs.phase_longrun(root, card)["runs"]
    print(f"launches of its runs: "
          f"{ {k: sum(r[k] for r in runs) for k in runs[0]} }", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    print(f"{time.perf_counter() - t0:.1f} s  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
