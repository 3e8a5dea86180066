"""The designs of kernel #6 (rank_count) that lost, timed against the
package's kernel on one card.

Usage, from the root of a checkout, on a machine with a card:

    python3 experiments/rank_count_designs.py

Builds ``experiments/rank_count_designs.cu`` with nvcc (its launchers have
``skrx_rank_count``'s signature): "linear" (design (1) as first measured:
every candidate key in shared memory, 4 probe keys a lane, 8 warps a
tile), "sorted" (design (2): a bitonic sort of each tile's keys, then a
lower-bound search a probe) and "runs" (design (3): a lower-bound search
in every ascending run of the tile). On the inputs of ``chip_ab.py``'s
phase 4 (BPRMF at Gowalla scale, seed 2021: the evaluation batch B=64,
W=550, T=416; B=1,024; B=64 with no two adjacent keys equal) each design's
counts must equal the package kernel's; then all are timed in turns (each
name, then the names in reverse) by device time per call
(``chip_smoke.device_ms``). Prints one line per case with the card's name,
power limit and SM clock, writes ``chiprun_out/rank_count_designs.json``;
exits 2 without CUDA.
"""
import json
import os
import shutil
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_ab as ab  # noqa: E402
from chip_smoke import card_line, device_ms, rank_segments  # noqa: E402
from skrx_torch import ModelRegistry, RunConfig  # noqa: E402
from skrx_torch.io import synthetic  # noqa: E402
from skrx_torch.ops.kernels import _build  # noqa: E402
from skrx_torch.ops.kernels import topk_blocks as tb  # noqa: E402

SOURCE = os.path.join(ROOT, "experiments", "rank_count_designs.cu")
DESIGNS = ("linear", "sorted", "runs")


def main() -> int:
    if not torch.cuda.is_available():
        print("rank_count_designs: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}", flush=True)
    libs, _ = ab.build({"designs": SOURCE},
                       os.path.join(ROOT, "build", "rank_count_designs"))
    _build.load("rank_counts")
    fns = {name: ab.c_fn(libs["designs"], SOURCE, f"skrx_rank_count_{name}")
           for name in DESIGNS}
    root = os.path.join(ROOT, "build", "rank_count_designs_data")
    shutil.rmtree(root, ignore_errors=True)
    path = synthetic.make_dataset_dir(root, num_users=ab.USERS,
                                      num_items=ab.ITEMS,
                                      num_ratings=ab.RATINGS, seed=ab.SEED)
    reg = ModelRegistry()
    reg.load_skrx_model("BPRMF")
    cls, _ = reg.get_model("BPRMF")
    bpr = cls(RunConfig(recommender="BPRMF", data_dir=path, seed=ab.SEED),
              {"n_dim": ab.DIM, "epochs": 1})
    rng = np.random.default_rng(ab.SEED)
    test_users = np.fromiter(bpr.evaluator.user_pos_test, np.int64)
    cases = ab.rank_count_cases(bpr, [rng.choice(test_users, bsz,
                                                 replace=False)
                                      for bsz in (64, 1024)])
    results = {"card": card}
    for note, cand_v, cand_i, s_t, probes in cases:
        b, w = cand_v.shape
        t = probes.shape[1]
        tag = f"B={b} W={w} T={t}{note}"
        ref = tb.rank_count(cand_v, cand_i, s_t, probes)
        outs = {name: torch.empty_like(ref) for name in DESIGNS}

        def runner(name):
            return lambda: fns[name](ab.ptr(cand_v), ab.ptr(cand_i), b, w,
                                     ab.ptr(s_t), ab.ptr(probes), t,
                                     ab.ptr(outs[name]))
        calls = {"package": lambda: tb.rank_count(cand_v, cand_i, s_t,
                                                  probes)}
        calls.update({name: runner(name) for name in DESIGNS})
        for name in DESIGNS:
            calls[name]()
        torch.cuda.synchronize()
        for name in DESIGNS:
            if not torch.equal(outs[name], ref):
                raise AssertionError(f"{name} at {tag}: not equal to the "
                                     "package's kernel")
        names = list(calls)
        times = ab.in_turns(calls, names + names[::-1])
        segs = rank_segments(cand_v, cand_i).double()
        results[tag] = times
        print(f"{tag} (each == the package's kernel; segments of equal keys "
              f"a row, mean {float(segs.mean())}): " + ", ".join(
                  f"{k} {np.mean(v)} ms {v}" for k, v in times.items())
              + f"  [{card}; SM clock after the turns {ab.sm_clock()}]",
              flush=True)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "rank_count_designs.json"),
              "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
