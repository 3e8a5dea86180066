"""Variants of kernel #1 (submax) timed against the package's kernel on one
card.

Usage, from the root of a checkout, on a machine with a card:

    python3 experiments/submax_variants.py

Builds ``experiments/submax_variants.cu`` with nvcc (its launchers have
``skrx_submax``'s signature): "scores_first" (the scores loaded before the
mask ids, as the design was first built), "bounds6" (scores_first held to
6 blocks an SM, 40 registers) and "staged" (the block's scores copied into
shared memory by cp.async before the mask scan, 8 blocks an SM). On the
inputs of ``chip_ab.py``'s phase 5 (BPRMF at Gowalla scale, seed 2021: the
evaluation batch B=64 with the evaluator's train table, and B=1,024 with
the seen table) each variant's maxima must equal the package kernel's as
int32 views; then all are timed in turns (each name, then the names in
reverse) by device time per call (``chip_smoke.device_ms``), with the
package's kernel on the same scores without a mask beside them (the
unmasked maxima: what the mask scan costs). Prints one
line per case with the card's name, power limit and SM clock, writes
``chiprun_out/submax_variants.json``; exits 2 without CUDA.
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
from chip_smoke import card_line  # noqa: E402
from skrx_torch import ModelRegistry, RunConfig  # noqa: E402
from skrx_torch.io import synthetic  # noqa: E402
from skrx_torch.ops.kernels import _build  # noqa: E402
from skrx_torch.ops.kernels import topk_blocks as tb  # noqa: E402
from skrx_torch.serve import TopKRecommender  # noqa: E402

SOURCE = os.path.join(ROOT, "experiments", "submax_variants.cu")
VARIANTS = ("scores_first", "bounds6", "staged")


def main() -> int:
    if not torch.cuda.is_available():
        print("submax_variants: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    libs, logs = ab.build({"variants": SOURCE},
                          os.path.join(ROOT, "build", "submax_variants"))
    for line in logs["variants"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    _build.load("topk_blocks")
    fns = {name: ab.c_fn(libs["variants"], SOURCE, f"skrx_submax_{name}")
           for name in VARIANTS}
    root = os.path.join(ROOT, "build", "submax_variants_data")
    shutil.rmtree(root, ignore_errors=True)
    path = synthetic.make_dataset_dir(root, num_users=ab.USERS,
                                      num_items=ab.ITEMS,
                                      num_ratings=ab.RATINGS, seed=ab.SEED)
    reg = ModelRegistry()
    reg.load_skrx_model("BPRMF")
    cls, _ = reg.get_model("BPRMF")
    bpr = cls(RunConfig(recommender="BPRMF", data_dir=path, seed=ab.SEED),
              {"n_dim": ab.DIM, "epochs": 1})
    ev = bpr.evaluator
    rng = np.random.default_rng(ab.SEED)
    test_users = np.fromiter(ev.user_pos_test, np.int64)
    u64 = rng.choice(test_users, 64, replace=False)
    u1k = torch.as_tensor(rng.integers(0, ab.USERS, 1024), device=dev)
    seen = TopKRecommender(bpr, k=10)._seen
    cases = {"B=64 (evaluation)": (
                 bpr.predict(u64),
                 torch.from_numpy(ev._tables_for(u64, ab.ITEMS)[0]).to(dev)),
             "B=1024 (serving)": (bpr.predict(u1k), seen[u1k])}
    results = {"card": card}
    for tag, (scores, mask) in cases.items():
        scores, mask = scores.contiguous(), mask.contiguous()
        b, n = scores.shape
        ref = tb.submax(scores, mask, ab.BLOCK_N)
        outs = {name: torch.empty_like(ref) for name in VARIANTS}

        def runner(name):
            return lambda: fns[name](ab.ptr(scores), b, n, ab.BLOCK_N,
                                     ab.ptr(mask), mask.shape[1],
                                     ab.ptr(outs[name]))
        calls = {"package": lambda: tb.submax(scores, mask, ab.BLOCK_N)}
        calls.update({name: runner(name) for name in VARIANTS})
        # another function, the unmasked maxima: what the mask scan costs
        calls["package, no mask"] = lambda: tb.submax(scores, None,
                                                      ab.BLOCK_N)
        for name in VARIANTS:
            calls[name]()
        torch.cuda.synchronize()
        for name in VARIANTS:
            if not torch.equal(outs[name].view(torch.int32),
                               ref.view(torch.int32)):
                raise AssertionError(f"{name} at {tag}: not equal to the "
                                     "package's kernel")
        names = list(calls)
        times = ab.in_turns(calls, names + names[::-1])
        results[tag] = times
        print(f"submax {tag}, L={mask.shape[1]} (each variant == the "
              f"package's kernel): " + ", ".join(
                  f"{k} {np.mean(v)} ms {v}" for k, v in times.items())
              + f"  [{card}; SM clock after the turns {ab.sm_clock()}]",
              flush=True)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "submax_variants.json"),
              "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
