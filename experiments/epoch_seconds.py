"""Seconds of ``fit()``'s training epoch for one checkout, so that two
trees can be compared in turns on one card, and the cost of Adam's two
arithmetics a step.

Usage, from the root of a checkout, on a machine with a card:

    python3 experiments/epoch_seconds.py [--tree DIR] [--data DIR]
        [--models BPRMF,SGAT,...] [--epochs N]

``--tree``: the checkout whose ``skrx_torch`` and ``chip_smoke.py`` are
imported (default: this one). To compare a parent with this tree, unpack
the parent's ``git archive`` under ``build/`` and run parent, this, this,
parent in one call. ``--data``: where the phase-3 data of ``chip_smoke.py``
(Gowalla scale, seed 2021, with phase 14's 4,096-d image and 384-d text
features) is made.

For each model of ``--models`` (default MODELS: BPRMF, LightGCN, MultVAE,
CDAE, FPMC, TransRec, SGAT, MGCN, SelfCF, BM3, SLMRec) at its defaults,
and SLMRec once more under ``ssl_task="FD+FM"`` (its default FAC draws
nothing in its step): ``--epochs`` calls of the model's ``_train_epoch``
(the epoch ``fit()`` runs, on the tree's own route), each timed between
syncs; one more under torch.profiler for the busy share; where the model
has a captured route (``captured_epochs``), one epoch on each route,
timed, and the eager one profiled. Then Adam alone, for BPRMF and LightGCN where ``--models``
holds them: a ``torch.optim.Adam`` over the model's tables, capturable
(f32 bias corrections on the device) and not (f64 on the host), with
gradients set, host ms a step over 200 steps between syncs and device ms
a step from torch.profiler over 50. Each result is a
line ``RESULT {json}``, with the card's name and power limit; exits 2
without CUDA.
"""
import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("BPRMF", "LightGCN", "MultVAE", "CDAE", "FPMC", "TransRec",
          "SGAT", "MGCN", "SelfCF", "BM3", "SLMRec")
# each model's runs: (tag, config over its defaults)
RUNS = {"SLMRec": (("SLMRec", {}), ("SLMRec FD+FM", {"ssl_task": "FD+FM"}))}
SHAPES = {"BPRMF": ((29_858, 64), (40_981, 64), (40_981,)),
          "LightGCN": ((29_858, 64), (40_981, 64))}


def report(**kw) -> None:
    print("RESULT " + json.dumps(kw), flush=True)


def adam_ms(shapes, capturable: bool, cs) -> tuple:
    """(host ms, device ms, busy share) of one Adam step over tables of
    ``shapes``."""
    gen = torch.Generator("cuda").manual_seed(0)
    params = [torch.randn(s, device="cuda", generator=gen,
                          requires_grad=True) for s in shapes]
    for p in params:
        p.grad = torch.randn(p.shape, device="cuda", generator=gen)
    opt = torch.optim.Adam(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                           capturable=capturable)
    for _ in range(5):
        opt.step()
    _, sec = cs.timed(lambda: [opt.step() for _ in range(200)])
    busy, heads = cs.busy_share(opt.step, reps=50, top=1000)
    device = sum(ms for _, ms, _ in heads) / 50
    return sec / 200 * 1e3, device, busy


def epoch_times(m, run: str, tag: str, card: str, epochs: int, cs,
                epoch_generator) -> dict:
    """Model m's fit() epochs timed, the busy share of one more, and on a
    captured route one epoch of each route timed, the eager one's busy
    share; a tree whose models run their epochs from the model
    (``run_epoch``, the steps' own draws from a step generator) or from
    the pipeline alone (before it)."""
    fit_s = [cs.timed(lambda: m._train_epoch(e))[1] for e in range(epochs)]
    busy, _ = cs.busy_share(lambda: m._train_epoch(epochs), reps=1,
                            warm=False)
    out = dict(tree=tag, model=run, card=card, fit_epoch_s=fit_s,
               fit_busy=busy)
    pipe = m.pipeline

    def epoch(e, captured):
        gen = epoch_generator(cs.SEED + 1, e, m.device)
        if hasattr(m, "run_epoch"):
            return m.run_epoch(gen, epoch_generator(
                cs.SEED + 1, e, m.device, stream=1), captured=captured)
        return pipe.run_epoch(gen, m.train_step, captured=captured)
    if getattr(m, "captured_epochs", False):
        for route in ("captured", "eager"):
            _, sec = cs.timed(lambda: epoch(50, route == "captured"))
            out[f"{route}_epoch_s"] = sec
        out["eager_busy"], _ = cs.busy_share(lambda: epoch(51, False),
                                             reps=1, warm=False)
    out["steps"] = pipe.num_batches
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--data", default=os.path.join(ROOT, "build",
                                                   "epoch_seconds_data"))
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--models", default=",".join(MODELS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("epoch_seconds: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    tree, data = os.path.abspath(args.tree), os.path.abspath(args.data)
    models = args.models.split(",")
    sys.path.insert(0, tree)
    import chip_smoke as cs
    from skrx_torch import ModelRegistry, RunConfig
    from skrx_torch.io import synthetic
    from skrx_torch.models.pipeline import epoch_generator
    from skrx_torch.ops.kernels import _build

    t0 = time.perf_counter()
    card = cs.card_line()
    tag = os.path.relpath(tree, ROOT)
    _build.load("segsum")                 # builds every kernel
    os.makedirs(data, exist_ok=True)
    path = synthetic.make_dataset_dir(data, num_users=cs.USERS,
                                      num_items=cs.ITEMS,
                                      num_ratings=cs.RATINGS, seed=cs.SEED)
    synthetic.write_mm_features(path, cs.ITEMS, cs.SEED, cs.IMG_DIM,
                                cs.TXT_DIM)
    print(f"{tag}: kernels and data ready in {time.perf_counter() - t0:.1f}"
          f" s  [{card}]", flush=True)
    cwd = os.getcwd()
    os.chdir(data)                        # model construction writes log/
    reg = ModelRegistry()
    try:
        for name in models:
            reg.load_skrx_model(name)
            for run, over in RUNS.get(name, ((name, {}),)):
                m = reg.get_model(name)[0](
                    RunConfig(recommender=name, data_dir=path, seed=cs.SEED),
                    dict(over))
                report(**epoch_times(m, run, tag, card, args.epochs, cs,
                                     epoch_generator))
                del m
                torch.cuda.empty_cache()
        for name, shapes in SHAPES.items():
            if name not in models:
                continue
            for capturable in (False, True):
                host, device, busy = adam_ms(shapes, capturable, cs)
                report(tree=tag, adam=name, capturable=capturable,
                       host_ms_step=host, device_ms_step=device, busy=busy,
                       card=card)
    finally:
        os.chdir(cwd)
    print(f"{tag}: {time.perf_counter() - t0:.1f} s  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
