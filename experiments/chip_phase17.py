"""Phase 17 of ``chip_smoke.py`` alone (every model of the port but
LightGCN and dense BPRMF on a (2, 2) mesh of 4 ranks sharing one card
through gloo, each against the same steps on one device), for work on the
mesh without the other phases.

Usage, from the root of a checkout, on a machine with a card:

    python3 experiments/chip_phase17.py

Builds the kernels, generates phase 3's data (seed 2021) under
``build/chip_phase17_data`` with phase 14's 4,096-d image and 384-d text
features, and runs ``chip_smoke.phase_mesh_models`` with all its checks;
prints its lines, the launches of its main-path runs (every rank's
summed), the card's name and power limit and the seconds taken. Exits 2
without CUDA.
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
        print("chip_phase17: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from skrx_torch.io import synthetic
    from skrx_torch.ops.kernels import _build

    t0 = time.perf_counter()
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    _build.load("segsum")                 # builds every kernel
    root = os.path.join(ROOT, "build", "chip_phase17_data")
    shutil.rmtree(root, ignore_errors=True)
    path = synthetic.make_dataset_dir(root, num_users=cs.USERS,
                                      num_items=cs.ITEMS,
                                      num_ratings=cs.RATINGS, seed=cs.SEED)
    synthetic.write_mm_features(path, cs.ITEMS, cs.SEED, cs.IMG_DIM,
                                cs.TXT_DIM)
    print(f"kernels and data ready in {time.perf_counter() - t0:.1f} s",
          flush=True)
    runs = cs.phase_mesh_models(path, os.path.join(root, "mesh_models"),
                                card)["runs"]
    print(f"launches of its main-path runs: "
          f"{ {k: sum(r[k] for r in runs) for k in runs[0]} }", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    print(f"{time.perf_counter() - t0:.1f} s  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
