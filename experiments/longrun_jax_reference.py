"""JAX's reference for ``scripts/longrun_torch.py``: the JAX package's
long-run sweep on the CPU, its per-epoch NDCG@10 curves, and the bands the
port's runs are held to.

Usage, from the root of a checkout with JAX installed:

    python experiments/longrun_jax_reference.py [--merge-only]

Runs ``scripts/longrun.py``'s ten models on its data (500 users, 800 items,
20,000 ratings, latent structure, item features) and ``RunConfig`` (NDCG@10,
test batch 256) in two modes, as four parallel processes on the CPU:

- ``sweep``: the sweep's hyper-parameters, run seeds 2021, 2022, 2023;
- ``default``: each model at its ``ModelConfig`` defaults, taking from the
  sweep only its epochs, run seed 2021.

Each process appends one JSON line a model to
``build/longrun_reference/<mode>_<seed>.jsonl`` (a rerun skips the models
already there); the merge writes ``experiments/longrun_reference.json``:
every evaluated epoch's NDCG@10 per model and seed, and per epoch budget E
the band of the best NDCG@10 through E. It holds NDCG values only.

The band, from JAX's seeds alone: over the sweep's seeds, mean mu and range
r of the best through E. The mean of the port's same seeds must lie within
``max(2 r, 0.05 mu)`` of mu; one seed of the port within ``[min - m, max +
m]``, ``m = max(r, 0.05 mu)``. The defaults mode has one seed; its half
width is its own value times the sweep's relative half width (and margin)
at the same E.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "experiments", "longrun_reference.json")
PARTS = os.path.join(ROOT, "build", "longrun_reference")
SWEEP_SEEDS = (2021, 2022, 2023)
DEFAULT_SEEDS = (2021,)


def _longrun():
    """``scripts/longrun.py`` as a module: its SWEEP and its data."""
    spec = importlib.util.spec_from_file_location(
        "skrx_longrun", os.path.join(ROOT, "scripts", "longrun.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_cpu():
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")


def make_data(root):
    """``scripts/longrun.py``'s dataset, written by JAX's generator."""
    from skrx.io import synthetic
    return synthetic.make_dataset_dir(root, num_users=500, num_items=800,
                                      num_ratings=20000, seed=3,
                                      latent_dim=6, latent_strength=6.0,
                                      with_mm=True, img_dim=24, txt_dim=16)


def run_one(name, hp, epochs, data, seed, mode):
    """One model's ``fit()``; every evaluated epoch's NDCG@10 and loss."""
    import numpy as np
    from skrx import RunConfig
    from skrx.utils import ModelRegistry
    reg = ModelRegistry()
    reg.load_skrx_model(name)
    cls, _ = reg.get_model(name)
    run = RunConfig(recommender=name, data_dir=data, file_column="UIRT",
                    sep="\t", metric=("NDCG",), top_k=(10,),
                    test_batch_size=256, seed=seed)
    cfg = dict(hp, epochs=epochs, early_stop=epochs) if mode == "sweep" \
        else dict(epochs=epochs, early_stop=epochs)
    model = cls(run, cfg)
    curve, losses = [], []
    epoch_of = {"now": -1}
    train_epoch, evaluate = model._train_epoch, model.evaluate

    def _train(epoch):
        epoch_of["now"] = epoch
        loss = train_epoch(epoch)
        losses.append(None if loss is None else float(loss))
        return loss

    def _evaluate(*a, **k):
        report = evaluate(*a, **k)
        curve.append([epoch_of["now"], float(report["NDCG@10"])])
        return report

    model._train_epoch, model.evaluate = _train, _evaluate
    t0 = time.time()
    model.fit()
    seconds = time.time() - t0
    nan = any(x is not None and not np.isfinite(x) for x in losses)
    return {"mode": mode, "model": name, "seed": seed, "epochs": epochs,
            "curve": curve, "loss_nan": bool(nan)}, seconds


def worker(mode, seed, part):
    _jax_cpu()
    sweep = _longrun().SWEEP
    done = set()
    if os.path.exists(part):
        with open(part) as f:
            done = {json.loads(line)["model"] for line in f if line.strip()}
    work = tempfile.mkdtemp(prefix=f"longrun_{mode}_{seed}_")
    data = make_data(work)
    os.chdir(work)                      # the models write log/ under cwd
    for name, hp, epochs in sweep:
        if name in done:
            continue
        rec, seconds = run_one(name, hp, epochs, data, seed, mode)
        with open(part, "a") as f:
            f.write(json.dumps(rec) + "\n")
        best = max(v for _, v in rec["curve"])
        print(f"[{mode} {seed}] {name:9s} {epochs:4d} epochs best NDCG@10 "
              f"{best:.4f} ({seconds / epochs:.2f} s/epoch, CPU)", flush=True)


def best_through(curve, epochs):
    """Best NDCG@10 over the evaluated epochs < E, for E = 1..epochs (None
    before the first evaluation)."""
    out, best, i = [], None, 0
    for e in range(1, epochs + 1):
        while i < len(curve) and curve[i][0] < e:
            best = curve[i][1] if best is None else max(best, curve[i][1])
            i += 1
        out.append(best)
    return out


def sweep_band(bests):
    """Per E: mu, r, the mean's half width max(2r, 0.05 mu) and one seed's
    interval [min - m, max + m], m = max(r, 0.05 mu)."""
    band = {"mu": [], "r": [], "half": [], "lo": [], "hi": []}
    for vals in zip(*bests):
        if any(v is None for v in vals):
            for key in band:
                band[key].append(None)
            continue
        mu = sum(vals) / len(vals)
        r = max(vals) - min(vals)
        m = max(r, 0.05 * mu)
        band["mu"].append(mu)
        band["r"].append(r)
        band["half"].append(max(2 * r, 0.05 * mu))
        band["lo"].append(min(vals) - m)
        band["hi"].append(max(vals) + m)
    return band


def default_band(best, sweep):
    """The defaults mode's one seed, with the sweep's relative widths."""
    band = {"mu": [], "half": [], "lo": [], "hi": []}
    for e, v in enumerate(best):
        idx = min(e, len(sweep["mu"]) - 1)
        mu_s = sweep["mu"][idx]
        if v is None or mu_s is None:
            for key in band:
                band[key].append(None)
            continue
        rel_half = sweep["half"][idx] / mu_s
        rel_m = max(sweep["r"][idx], 0.05 * mu_s) / mu_s
        band["mu"].append(v)
        band["half"].append(rel_half * v)
        band["lo"].append(v - rel_m * v)
        band["hi"].append(v + rel_m * v)
    return band


def merge():
    sweep = _longrun().SWEEP
    runs = {}
    for mode, seeds in (("sweep", SWEEP_SEEDS), ("default", DEFAULT_SEEDS)):
        for seed in seeds:
            with open(os.path.join(PARTS, f"{mode}_{seed}.jsonl")) as f:
                for line in f:
                    rec = json.loads(line)
                    runs[(mode, rec["model"], seed)] = rec
    out = {
        "source": "skrx (JAX) on the CPU, jax_platforms=cpu; "
                  "experiments/longrun_jax_reference.py",
        "data": dict(num_users=500, num_items=800, num_ratings=20000,
                     seed=3, latent_dim=6, latent_strength=6.0,
                     with_mm=True, img_dim=24, txt_dim=16),
        "run": dict(file_column="UIRT", sep="\t", metric=["NDCG"],
                    top_k=[10], test_batch_size=256),
        "band_rule": "per epoch budget E, over the sweep's seeds: mu, r of "
                     "the best NDCG@10 through E; the port's mean over the "
                     "same seeds within max(2r, 0.05mu) of mu; one seed "
                     "within [min - m, max + m], m = max(r, 0.05mu). "
                     "default: its one seed times the sweep's relative "
                     "widths at the same E",
        "modes": {"sweep": {"seeds": list(SWEEP_SEEDS), "models": {}},
                  "default": {"seeds": list(DEFAULT_SEEDS), "models": {}}},
    }
    for name, hp, epochs in sweep:
        recs = [runs[("sweep", name, s)] for s in SWEEP_SEEDS]
        bests = [best_through(r["curve"], epochs) for r in recs]
        band = sweep_band(bests)
        out["modes"]["sweep"]["models"][name] = {
            "hp": hp, "epochs": epochs,
            "curves": {str(r["seed"]): r["curve"] for r in recs},
            "loss_nan": any(r["loss_nan"] for r in recs),
            "band": band}
        d = runs[("default", name, DEFAULT_SEEDS[0])]
        out["modes"]["default"]["models"][name] = {
            "epochs": epochs,
            "curves": {str(d["seed"]): d["curve"]},
            "loss_nan": d["loss_nan"],
            "band": default_band(best_through(d["curve"], epochs), band)}
    with open(OUT, "w") as f:
        json.dump(out, f, separators=(",", ":"))
        f.write("\n")
    print(f"wrote {OUT}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", nargs=2, metavar=("MODE", "SEED"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--merge-only", action="store_true",
                    help="merge the existing parts into the JSON file")
    args = ap.parse_args(argv)
    os.makedirs(PARTS, exist_ok=True)
    if args.worker:
        mode, seed = args.worker[0], int(args.worker[1])
        worker(mode, seed, os.path.join(PARTS, f"{mode}_{seed}.jsonl"))
        return 0
    if not args.merge_only:
        jobs = [("sweep", s) for s in SWEEP_SEEDS] + \
               [("default", s) for s in DEFAULT_SEEDS]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", mode,
             str(seed)])
            for mode, seed in jobs]
        if any(p.wait() != 0 for p in procs):
            return 1
    merge()
    return 0


if __name__ == "__main__":
    sys.exit(main())
