"""JAX's own seed spread on the long-run data in the first epochs, beside
the port's: what the defaults mode's reference, one JAX seed, cannot show.

Usage, from the root of a checkout with JAX installed (the port's side
first, on the CPU or the card):

    python3 scripts/longrun_torch.py --device cpu --widths default \\
        --models MultVAE,BM3,SASRec,GRU4Rec --seeds 4 --epochs 10 \\
        --json build/longrun_seeds_port.jsonl
    python3 experiments/longrun_seeds_jax.py --widths default \\
        --models MultVAE,BM3,SASRec,GRU4Rec --seeds 4 --epochs 10 \\
        --port build/longrun_seeds_port.jsonl

Runs each model of ``scripts/longrun.py``'s sweep on its data at run seeds
2021 ... 2021 + S - 1 with JAX on the CPU (``jax_platforms=cpu``), at the
sweep's widths or its ``ModelConfig`` defaults, and prints per model and
epoch budget E the best NDCG@10 through E of each JAX seed, their mean and
range, and the mean and range of the port's same seeds read from the JSON
lines of ``scripts/longrun_torch.py``; with the port's seeds also whether
the port's mean lies within JAX's mean +- max(2 r, 0.05 mu) (the sweep's
band, r JAX's range) and the two-sided Welch t and p of the two sets of
seeds (``scipy.stats.ttest_ind(equal_var=False)``).
"""
import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import longrun_jax_reference as ref  # noqa: E402

FIRST_SEED = 2021


def welch(a, b):
    """Two-sided Welch t and p of ``a`` against ``b``."""
    from scipy import stats
    res = stats.ttest_ind(a, b, equal_var=False)
    return float(res.statistic), float(res.pvalue)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--widths", choices=("sweep", "default"),
                    default="default")
    ap.add_argument("--models", required=True,
                    help="comma-separated models of the sweep")
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--port", default="",
                    help="JSON lines of scripts/longrun_torch.py")
    args = ap.parse_args(argv)
    ref._jax_cpu()
    sweep = {name: hp for name, hp, _ in ref._longrun().SWEEP}
    models = args.models.split(",")
    seeds = range(FIRST_SEED, FIRST_SEED + args.seeds)
    port = {}
    if args.port:
        with open(args.port) as f:
            for line in f:
                rec = json.loads(line)
                if rec["widths"] == args.widths and rec["seed"] in seeds:
                    port[(rec["model"], rec["seed"])] = rec["curve"]
    work = tempfile.mkdtemp(prefix="longrun_seeds_")
    data = ref.make_data(work)
    os.chdir(work)                      # the models write log/ under cwd
    for name in models:
        jax_bests = [ref.best_through(ref.run_one(
            name, sweep[name], args.epochs, data, seed, args.widths)[0][
                "curve"], args.epochs) for seed in seeds]
        port_bests = [ref.best_through(port[(name, seed)], args.epochs)
                      for seed in seeds if (name, seed) in port]
        print(f"{name} ({args.widths}), best NDCG@10 through E: JAX seeds "
              f"{list(seeds)} on the CPU; port {len(port_bests)} seeds")
        print(f"{'E':>3s} {'JAX seeds':>36s} {'mean':>7s} {'range':>7s} "
              f"{'port mean':>9s} {'range':>7s} {'in band':>7s} "
              f"{'Welch t':>8s} {'p':>7s}")
        for e in range(args.epochs):
            vals = [b[e] for b in jax_bests]
            line = (f"{e + 1:3d} {' '.join(f'{v:.4f}' for v in vals):>36s}"
                    f" {sum(vals) / len(vals):7.4f} "
                    f"{max(vals) - min(vals):7.4f}")
            if port_bests:
                pv = [b[e] for b in port_bests]
                mu, r = sum(vals) / len(vals), max(vals) - min(vals)
                pmu = sum(pv) / len(pv)
                inside = abs(pmu - mu) <= max(2 * r, 0.05 * mu)
                t, p = welch(pv, vals)
                line += (f" {pmu:9.4f} {max(pv) - min(pv):7.4f} "
                         f"{'yes' if inside else 'NO':>7s} {t:8.3f} {p:7.4f}")
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
