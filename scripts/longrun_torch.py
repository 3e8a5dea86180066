"""Long-run convergence sweep of the PyTorch port on the card: the port of
``scripts/longrun.py``. One model per family trains for 100-150 epochs on
a mid-size synthetic dataset with latent user-item structure; every
evaluated epoch's NDCG@10 is recorded and the best is held to the JAX
package's band from ``experiments/longrun_reference.json``. It catches what
the per-step checks cannot: divergence, NaN leaks, and quality that drifts
from the JAX package's over many epochs.

Usage, from the root of a checkout:

    python3 scripts/longrun_torch.py [--seeds S] [--epochs N] [--quick]
        [--widths sweep|default] [--models A,B] [--device cuda|cpu]
        [--json PATH]

- ``--seeds S``: run seeds 2021 ... 2021 + S - 1, the data fixed.
- ``--widths default``: each model at its ``ModelConfig`` defaults, taking
  from the sweep only its epochs (and the data).
- ``--epochs N`` overrides every model's epochs, ``--quick`` runs 5.
- ``--json PATH`` appends one line a model and seed: the NDCG@10 of every
  evaluated epoch, the best and its epoch, seconds per epoch, whether a
  loss was NaN, the kernels' launches and the card's name and power limit.
- ``--summary PATH`` trains nothing: it prints the summary below for the
  lines of a ``--json`` file at ``--widths``.

The data are ``scripts/longrun.py``'s (500 users, 800 items, 20,000
ratings, seed 3, latent_dim 6, strength 6.0, item features), written by
the port's copy of JAX's generator, byte-equal to JAX's files. The
``RunConfig`` is the sweep's: NDCG@10, test batch 256. At the end it prints,
per model, the mean over the seeds of the best NDCG@10 beside the JAX
reference's band at the same epoch budget (when the file holds one), and
the budgets E below it at which the mean of the best through E lies
outside the band at E.
"""
import argparse
import json
import math
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

REFERENCE = os.path.join(ROOT, "experiments", "longrun_reference.json")
FIRST_SEED = 2021

# scripts/longrun.py's SWEEP, unchanged: one per family (MF, VAE, session
# RNN, seq attention, masked LM, seq CNN, metric learning, graph CF, graph
# CL, multimodal SSL)
SWEEP = [
    ("BPRMF", dict(lr=0.01, n_dim=32, batch_size=512), 150),
    ("MultVAE", dict(lr=0.005, p_dims=[32], batch_size=128), 100),
    ("GRU4Rec", dict(lr=0.05, layers=[32], batch_size=32), 100),
    ("SASRec", dict(lr=0.01, hidden_units=32, max_len=20, num_blocks=2,
                    num_heads=2, batch_size=128), 100),
    ("BERT4Rec", dict(lr=1e-3, max_seq_len=16, h_size=32, att_heads=2,
                      n_layers=2, batch_size=128, verbose=5), 100),
    ("Caser", dict(lr=0.01, embed_size=32, seq_L=5, seq_T=3, nv=2, nh=8,
                   batch_size=512), 100),
    ("CML", dict(lr=0.05, reg=1.0, embed_size=32, dns=5, batch_size=256), 100),
    ("LightGCN", dict(lr=0.01, embed_size=32, n_layers=3,
                      batch_size=512), 150),
    ("LightGCL", dict(lr=0.01, d=32, gnn_layer=2, svd_q=5,
                      batch_size=512), 100),
    ("BM3", dict(lr=0.01, embed_dim=32, n_layers=2, batch_size=512), 100),
]
DATA = dict(num_users=500, num_items=800, num_ratings=20000, seed=3,
            latent_dim=6, latent_strength=6.0, with_mm=True, img_dim=24,
            txt_dim=16)


def make_data(root: str) -> str:
    from skrx_torch.io import synthetic
    return synthetic.make_dataset_dir(root, **DATA)


def model_config(hp: dict, epochs: int, widths: str) -> dict:
    """The sweep's hyper-parameters, or the defaults with its epochs."""
    if widths == "sweep":
        return dict(hp, epochs=epochs, early_stop=epochs)
    return dict(epochs=epochs, early_stop=epochs)


def run_model(name: str, hp: dict, epochs: int, data: str, seed: int,
              device, widths: str = "sweep") -> dict:
    """One ``fit()`` at the sweep's ``RunConfig``; returns the record of a
    JSON line (without the card) and the launches of each kernel."""
    import numpy as np
    import torch
    from skrx_torch import RunConfig
    from skrx_torch.ops.kernels import runtime
    from skrx_torch.utils import ModelRegistry
    reg = ModelRegistry()
    reg.load_skrx_model(name)
    cls, _ = reg.get_model(name)
    run = RunConfig(recommender=name, data_dir=data, file_column="UIRT",
                    sep="\t", metric=("NDCG",), top_k=(10,),
                    test_batch_size=256, seed=seed)
    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    model = cls(run, model_config(hp, epochs, widths), device=device)
    build = time.perf_counter() - t0
    if cuda:
        torch.cuda.synchronize()
    runtime.reset_launches()
    t0 = time.perf_counter()
    model.fit()
    if cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(runtime.LAUNCHES)
    curve = [[h["epoch"], float(h["report"]["NDCG@10"])]
             for h in model.history if "report" in h]
    losses = [h["loss"] for h in model.history]
    best_epoch, best = max(curve, key=lambda c: (c[1], -c[0])) if curve \
        else (None, float("nan"))
    return {"model": name, "widths": widths, "seed": seed,
            "epochs": epochs, "ran_epochs": len(model.history),
            "curve": curve, "best": best, "best_epoch": best_epoch,
            "loss_nan": any(x is not None and not np.isfinite(x)
                            for x in losses),
            "seconds_per_epoch": seconds / max(1, len(model.history)),
            "train_seconds_per_epoch": float(np.mean(
                [h["train_seconds"] for h in model.history])),
            "build_seconds": build, "launches": launches,
            "device": str(device)}


def load_reference(path: str = REFERENCE):
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def best_through(curve, epochs: int):
    """The best NDCG@10 over the evaluated epochs below ``epochs``."""
    vals = [v for e, v in curve if e < epochs]
    return max(vals) if vals else None


def band_at(ref, widths: str, name: str, epochs: int):
    """The reference's band at an epoch budget: (mu, half width, lo, hi)
    or None where the file has no value for it."""
    if ref is None:
        return None
    entry = ref["modes"][widths]["models"].get(name)
    if entry is None or not 1 <= epochs <= len(entry["band"]["mu"]):
        return None
    band = entry["band"]
    i = epochs - 1
    if band["mu"][i] is None:
        return None
    return band["mu"][i], band["half"][i], band["lo"][i], band["hi"][i]


def card_line(device) -> str:
    import torch
    if torch.device(device).type != "cuda":
        return "cpu"
    from skrx_torch.utils.chip import card_line as smi
    return smi()


def summarize(ref, widths: str, summary) -> None:
    """Per model (name, epoch budget, one curve a seed): the mean of the
    seeds' best NDCG@10 against the reference's band at the budget, and
    the budgets below it where the mean lies outside the band. A mean of
    several seeds, or the defaults' one seed against JAX's one, is held
    within the half width; one seed of the sweep within JAX's seeds'
    interval."""
    print(f"\n{'model':10s} {'epochs':>6s} {'port mean':>10s} "
          f"{'range':>9s} {'JAX mu':>9s} {'half':>8s} within  "
          f"outside at E")
    for name, epochs, curves in summary:
        outside = []
        for e in range(1, epochs + 1):
            bests = [best_through(c, e) for c in curves]
            band = band_at(ref, widths, name, e)
            if band is None or None in bests:
                continue
            mean = sum(bests) / len(bests)
            mu, half, lo, hi = band
            within = (abs(mean - mu) <= half
                      if len(bests) > 1 or widths == "default"
                      else lo <= mean <= hi)
            if not within:
                outside.append(e)
        bests = [best_through(c, epochs) for c in curves]
        mean = sum(bests) / len(bests)
        band = band_at(ref, widths, name, epochs)
        if band is None:
            verdict, mu, half = "no reference", float("nan"), float("nan")
        else:
            mu, half = band[0], band[1]
            verdict = "NO" if epochs in outside else "yes"
        print(f"{name:10s} {epochs:6d} {mean:10.6f} "
              f"{max(bests) - min(bests):9.6f} {mu:9.6f} {half:8.6f} "
              f"{verdict:6s}  {outside}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=1,
                    help="run seeds 2021 ... 2021 + S - 1")
    ap.add_argument("--epochs", type=int, default=None,
                    help="override every model's epoch budget")
    ap.add_argument("--quick", action="store_true", help="5 epochs each")
    ap.add_argument("--widths", choices=("sweep", "default"),
                    default="sweep")
    ap.add_argument("--models", default="",
                    help="comma-separated subset of the sweep's models")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default="", help="append JSON lines here")
    ap.add_argument("--summary", default="",
                    help="summarise the JSON lines of an earlier run")
    args = ap.parse_args(argv)
    if args.summary:
        with open(args.summary) as f:
            recs = [json.loads(line) for line in f if line.strip()]
        recs = [r for r in recs if r["widths"] == args.widths]
        order = [name for name, _, _ in SWEEP]
        summarize(load_reference(), args.widths, [
            (name, max(r["epochs"] for r in recs if r["model"] == name),
             [r["curve"] for r in recs if r["model"] == name])
            for name in order if any(r["model"] == name for r in recs)])
        return 0
    import torch
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("longrun_torch: CUDA is not available", file=sys.stderr)
        return 2
    wanted = [m for m in args.models.split(",") if m]
    unknown = set(wanted) - {name for name, _, _ in SWEEP}
    if unknown:
        ap.error(f"not in the sweep: {sorted(unknown)}")
    ref = load_reference()
    card = card_line(args.device)
    work = tempfile.mkdtemp(prefix="longrun_torch_")
    data = make_data(work)
    cwd = os.getcwd()
    os.chdir(work)                          # the models write log/ here
    json_path = os.path.join(cwd, args.json) if args.json else ""
    print(f"card: {card}; torch {torch.__version__}; widths {args.widths}",
          flush=True)
    print(f"{'model':10s} {'seed':>5s} {'epochs':>6s} {'best NDCG@10':>12s} "
          f"{'at':>4s} {'s/epoch':>9s}", flush=True)
    failed = False
    summary = []
    for name, hp, epochs in SWEEP:
        if wanted and name not in wanted:
            continue
        if args.quick:
            epochs = 5
        if args.epochs:
            epochs = args.epochs
        curves = []
        for seed in range(FIRST_SEED, FIRST_SEED + args.seeds):
            rec = run_model(name, hp, epochs, data, seed, args.device,
                            args.widths)
            rec["card"] = card
            curves.append(rec["curve"])
            failed |= rec["loss_nan"] or not math.isfinite(rec["best"])
            print(f"{name:10s} {seed:5d} {epochs:6d} {rec['best']:12.6f} "
                  f"{rec['best_epoch']:4d} {rec['seconds_per_epoch']:9.4f}"
                  f"{'  NaN loss' if rec['loss_nan'] else ''}  [{card}]",
                  flush=True)
            if json_path:
                with open(json_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
        summary.append((name, epochs, curves))
    os.chdir(cwd)
    summarize(ref, args.widths, summary)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
