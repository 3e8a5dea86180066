"""Every model of the port trained twice on one card from one seed, and
the operations PyTorch itself flags as nondeterministic on its train path.

Usage, from the root of a checkout, on a machine with a card:

    python3 experiments/determinism_scan.py

On phase 3's data of ``chip_smoke.py`` (Gowalla scale, seed 2021) with
phase 14's 4,096-d image and 384-d text features, LightGCN and the 25
models of phase 17 (BPRMF with lazy Adam) are built as phase 17 builds
them on one device
(``chip_smoke._p17_model`` at ``chip_smoke.FULL_DEPTH``: its default
widths, one epoch cut to 20 steps, fewer for the wide multimodal tables,
evaluated on 1,024 test users) and fit() three times: twice as it runs,
whose parameters and epoch losses must be bit-equal, then once under
``torch.use_deterministic_algorithms(True, warn_only=True)``, whose
warnings name each operation with no deterministic card implementation
(an operation that has one, such as ``index_add_``, switches to it there
and is not named: ``tests/test_torch_port_rules.py`` bars those from the
port). Prints one line per model with the card's name and power limit and
writes ``chiprun_out/determinism_scan.json``; exits 1 when a model's two
runs differ, 2 without CUDA.
"""
import json
import os
import re
import shutil
import sys
import time
import warnings

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    if not torch.cuda.is_available():
        print("determinism_scan: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    cs.full_depth()                       # phase 17's steps before the cut
    from skrx_torch.io import synthetic
    from skrx_torch.ops.kernels import _build

    t0 = time.perf_counter()
    card = cs.card_line()
    dev = torch.device("cuda", 0)
    _build.load("segsum")
    root = os.path.join(ROOT, "build", "determinism_scan_data")
    shutil.rmtree(root, ignore_errors=True)
    path = synthetic.make_dataset_dir(root, num_users=cs.USERS,
                                      num_items=cs.ITEMS,
                                      num_ratings=cs.RATINGS, seed=cs.SEED)
    synthetic.write_mm_features(path, cs.ITEMS, cs.SEED, cs.IMG_DIM,
                                cs.TXT_DIM)
    cwd = os.getcwd()
    os.chdir(root)
    record, differ = {"card": card, "models": {}}, []
    for name in ("LightGCN",) + cs.P17_MODELS:
        runs = []
        for run in range(3):
            m, steps = cs._p17_model(name, path, dev)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if run == 2:
                    torch.use_deterministic_algorithms(True, warn_only=True)
                try:
                    m.fit()
                finally:
                    torch.use_deterministic_algorithms(False)
            flagged = sorted({re.sub(r"\s+", " ", str(w.message))[:160]
                              for w in caught
                              if "deterministic" in str(w.message)})
            runs.append(({k: p.detach().cpu().clone()
                          for k, p in m.named_parameters()},
                         m.history[0]["loss"], flagged))
            del m
            torch.cuda.empty_cache()
        (first, loss0, _), (second, loss1, _), (_, _, flagged) = runs
        equal = loss0 == loss1 and all(
            torch.equal(first[k].view(torch.int32), second[k].view(torch.int32))
            if first[k].dtype == torch.float32 else torch.equal(first[k],
                                                               second[k])
            for k in first)
        key = f"{name} (lazy Adam)" if name == "BPRMF" else name
        record["models"][key] = {"steps": steps, "bit_equal": equal,
                                 "loss": loss0, "flagged": flagged}
        if not equal:
            differ.append(key)
        print(f"{key}: {steps} steps, run twice bit-equal {equal} (loss "
              f"{loss0} and {loss1}); flagged by PyTorch's deterministic "
              f"mode: {flagged or 'nothing'}  [{card}]", flush=True)
    os.chdir(cwd)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "determinism_scan.json"),
              "w") as f:
        json.dump(record, f, indent=1)
    print(f"models whose two runs differ: {differ or 'none'}; "
          f"{time.perf_counter() - t0:.1f} s  [{card}]", flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
