"""Seconds of one whole training epoch on the card, for the models whose
training step sums rows (their gathers' gradients, SGAT's attention,
LATTICE's learned graph, AOBPR's updates and draws, GRU4RecPlus's
negatives), in this tree and, in the same call, in another tree.

Usage, from the root of a checkout, on a machine with a card:

    python3 experiments/epoch_times.py [--parent DIR]

Generates ``chip_smoke.py``'s phase 3 data (Gowalla scale, seed 2021) with
phase 14's 4,096-d image and 384-d text features once under
``build/epoch_times_data``; then, for each tree in turn (``DIR``, this
tree, this tree again, ``DIR`` again when ``--parent`` is given: in
turns, so that a drift of the host shows), a process of its own builds
each model by name at its JAX package's defaults on the card and times
one whole ``_train_epoch`` between two synchronisations (the host clock),
with its steps. Prints one line per tree and model with the card's name
and power limit, and writes ``chiprun_out/epoch_times.json``; exits 2
without CUDA.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("SGAT", "LATTICE", "GRU4Rec", "GRU4RecPlus", "SASRec", "BERT4Rec",
          "SRGNN", "BM3", "SLMRec", "FREEDOM", "MGCN", "AOBPR")


def child(tree: str, path: str) -> None:
    """One tree's epochs, one JSON line a model on stdout."""
    sys.path.insert(0, tree)
    os.chdir(os.path.dirname(path))
    import torch
    from skrx_torch import ModelRegistry, RunConfig
    from skrx_torch.ops.kernels import _build
    on_card = torch.cuda.is_available()     # a CPU rehearsal: the plain
    if on_card:                             # versions, nothing built
        _build.load("segsum")
    reg = ModelRegistry()
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    for name in MODELS:
        reg.load_skrx_model(name)
        m = reg.get_model(name)[0](RunConfig(recommender=name, data_dir=path,
                                             seed=2021),
                                   {"epochs": 1, "early_stop": 1}, device=dev)
        if hasattr(m, "step_limit"):             # GRU4Rec's walk
            steps = int(m.epoch_schedule(0)[0].shape[0])
        else:
            steps = (m if hasattr(m, "num_batches") else m.pipeline
                     ).num_batches
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        sync()
        t0 = time.perf_counter()
        m._train_epoch(0)
        sync()
        sec = time.perf_counter() - t0
        print(json.dumps({"model": name, "seconds": sec, "steps": steps}),
              flush=True)
        del m
        torch.cuda.empty_cache()


def main() -> int:
    if "--child" in sys.argv:
        child(sys.argv[2], sys.argv[3])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("epoch_times: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from skrx_torch.io import synthetic
    card = cs.card_line()
    parent = None
    if "--parent" in sys.argv:
        parent = os.path.abspath(sys.argv[sys.argv.index("--parent") + 1])
    root = os.path.join(ROOT, "build", "epoch_times_data")
    path = synthetic.make_dataset_dir(root, num_users=cs.USERS,
                                      num_items=cs.ITEMS,
                                      num_ratings=cs.RATINGS, seed=cs.SEED)
    synthetic.write_mm_features(path, cs.ITEMS, cs.SEED, cs.IMG_DIM,
                                cs.TXT_DIM)
    trees = [ROOT] if parent is None else [parent, ROOT, ROOT, parent]
    record = {"card": card, "runs": []}
    for turn, tree in enumerate(trees):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", tree, path], capture_output=True,
                             text=True, timeout=1800)
        if out.returncode:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        rows = [json.loads(line) for line in out.stdout.splitlines()
                if line.startswith("{")]
        tag = "parent" if tree == parent else "this tree"
        record["runs"].append({"turn": turn, "tree": tag, "epochs": rows})
        for r in rows:
            print(f"turn {turn} ({tag}) {r['model']}: one epoch "
                  f"{r['seconds']} s, {r['steps']} steps  [{card}]",
                  flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "epoch_times.json"),
              "w") as f:
        json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
