"""Phase 13 of ``chip_smoke.py`` alone (GRU4Rec, GRU4RecPlus, SASRec,
BERT4Rec and SRGNN at Gowalla scale), for work on those models without the
other phases.

Usage, from the root of a checkout, on a machine with a card:

    python3 experiments/chip_phase13.py

Builds the kernels, generates phase 3's data (seed 2021) under
``build/chip_phase13_data`` and runs ``chip_smoke.phase_sequence_towers``
at ``chip_smoke.FULL_DEPTH`` (the depth before the script's cut) with all
its checks; prints its lines, the card's name and power limit, the peak
device memory and the seconds taken (~3 min on an H100).
Exits 2 without CUDA.
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
        print("chip_phase13: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    cs.full_depth()                       # the depth before the cut
    from skrx_torch import ModelRegistry
    from skrx_torch.io import synthetic
    from skrx_torch.ops.kernels import _build

    t0 = time.perf_counter()
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    _build.load("segsum")                 # builds every kernel
    root = os.path.join(ROOT, "build", "chip_phase13_data")
    shutil.rmtree(root, ignore_errors=True)
    path = synthetic.make_dataset_dir(root, num_users=cs.USERS,
                                      num_items=cs.ITEMS,
                                      num_ratings=cs.RATINGS, seed=cs.SEED)
    print(f"kernels and data ready in {time.perf_counter() - t0:.1f} s",
          flush=True)
    errs: dict = {}
    cs.phase_sequence_towers(path, ModelRegistry(), torch.device("cuda", 0),
                             card, errs)
    shutil.rmtree(root, ignore_errors=True)
    print(f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30} GiB; "
          f"{time.perf_counter() - t0:.1f} s  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
