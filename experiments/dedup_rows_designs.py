"""Two designs of lazy Adam's duplicate-row sums (``dedup_rows``,
``skrx_torch/ops/optim.py``) timed against each other on one card.

Usage, from the root of a checkout, on a machine with a card:

    python3 experiments/dedup_rows_designs.py

"segment_reduce" is the package's design: the rows sorted (stable), the
length of each run of equal rows counted by ``scatter_add_``, and every run
summed by one ``torch.segment_reduce``. "doubling" is the design it
replaced: a segmented suffix sum of ceil(log2 K) doubling steps (a compare,
a ``where`` and an add each), then an ``index_copy_`` of each run's head
into K + 1 slots. Neither adds through atomics.

On BPRMF's lazy-Adam batches at Gowalla scale (synthetic data, seed 2021:
1,024 user rows, 2,048 item rows of d = 64 and 2,048 item-bias rows a step)
each design must list the distinct rows, sum within 1e-5 of each table's
largest summed magnitude of a float64 sum, and give the same bits in two
calls. Then, in turns (segment_reduce, doubling, doubling, segment_reduce):
each table's ``dedup_rows`` by device time per call
(``chip_smoke.device_ms``), device kernels a call and CUDA-event time; one
whole lazy step (``BPRMF.train_step``, the design swapped in) by device
time, CUDA events around one call and back to back
(``chip_smoke.launches_ms``); one training epoch (716 steps) by the host
clock; and for each design one epoch run twice from one state, which must
give bit-equal tables, moments and counts. Prints one line per case with
the card's name and power limit, writes
``chiprun_out/dedup_rows_designs.json``; exits 2 without CUDA.
"""
import json
import os
import shutil
import sys
from itertools import islice

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from skrx_torch import ModelRegistry, RunConfig  # noqa: E402
from skrx_torch.io import synthetic  # noqa: E402
from skrx_torch.models.pipeline import epoch_generator  # noqa: E402
from skrx_torch.ops import optim  # noqa: E402


def dedup_doubling(rows: torch.Tensor, grads: torch.Tensor, drop_id: int):
    """The replaced design: the same contract as ``optim.dedup_rows``."""
    k = rows.shape[0]
    rows_s, order = torch.sort(rows.long(), stable=True)
    g = grads[order]
    is_first = torch.ones(k, dtype=torch.bool, device=rows.device)
    is_first[1:] = rows_s[1:] != rows_s[:-1]
    seg = torch.cumsum(is_first, 0) - 1
    step = 1
    while step < k:                  # each position ends holding the sum
        same = seg[step:] == seg[:-step]       # of its segment's rest
        if g.dim() == 2:
            same = same[:, None]
        g[:-step] += torch.where(same, g[step:], 0.0)
        step *= 2
    slot = torch.where(is_first, seg, k)       # non-heads to spare slot K
    unique = torch.full((k + 1,), drop_id, dtype=torch.int64,
                        device=rows.device)
    unique.index_copy_(0, slot, rows_s)
    summed = grads.new_zeros((k + 1,) + grads.shape[1:])
    summed.index_copy_(0, slot, g)
    return unique[:k], summed[:k]


DESIGNS = {"segment_reduce": optim.dedup_rows, "doubling": dedup_doubling}
TURNS = ("segment_reduce", "doubling", "doubling", "segment_reduce")


def kernels_per_call(fn, reps: int = 20) -> float:
    """Device kernels and copies a call of fn launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(1 for _ in cs._raw_device_events(prof)) / reps


def check_sums(cases) -> dict:
    """Each design against a float64 sum on the CPU; two calls bit-equal."""
    errs = {}
    for table, (rows, grads, drop) in cases.items():
        uniq, inverse = torch.unique(rows.cpu(), return_inverse=True)
        ref = torch.zeros((len(uniq),) + tuple(grads.shape[1:]),
                          dtype=torch.float64)
        ref.index_add_(0, inverse, grads.cpu().double())
        scale = float(ref.abs().max())
        n = len(uniq)
        for name, fn in DESIGNS.items():
            u, s = (t.cpu() for t in fn(rows, grads, drop))
            u2, s2 = (t.cpu() for t in fn(rows, grads, drop))
            cs.require(torch.equal(u[:n], uniq) and bool((u[n:] == drop)
                                                         .all()),
                       f"{name} {table}: distinct rows")
            cs.require(bool((s[n:] == 0).all()), f"{name} {table}: spare "
                       f"slots not zero")
            err = float((s[:n].double() - ref).abs().max())
            cs.require(err <= 1e-5 * scale, f"{name} {table}: sums off by "
                       f"{err} (scale {scale})")
            cs.require(torch.equal(u, u2) and s.numpy().tobytes()
                       == s2.numpy().tobytes(),
                       f"{name} {table}: two calls differ")
            errs[f"{name} {table}"] = err
    return errs


def main() -> int:
    if not torch.cuda.is_available():
        print("dedup_rows_designs: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    root = os.path.join(ROOT, "build", "dedup_rows_data")
    shutil.rmtree(root, ignore_errors=True)
    path = synthetic.make_dataset_dir(root, num_users=cs.USERS,
                                      num_items=cs.ITEMS,
                                      num_ratings=cs.RATINGS, seed=cs.SEED)
    reg = ModelRegistry()
    reg.load_skrx_model("BPRMF")
    cls, _ = reg.get_model("BPRMF")
    model = cls(RunConfig(recommender="BPRMF", data_dir=path, seed=cs.SEED),
                {"n_dim": cs.DIM, "epochs": 1, "optimizer": "lazy_adam"})
    users, pos, neg, _ = next(islice(
        model.pipeline.batches(epoch_generator(cs.SEED, 0, dev)), 3, None))
    batch = next(model.pipeline.batches(epoch_generator(cs.SEED, 1, dev)))
    gen = torch.Generator(dev).manual_seed(cs.SEED)
    item_rows = torch.cat([pos, neg[:, 0]])
    cases = {
        "user_emb": (users, torch.randn((len(users), cs.DIM), device=dev,
                                        generator=gen), cs.USERS),
        "item_emb": (item_rows, torch.randn((len(item_rows), cs.DIM),
                                            device=dev, generator=gen),
                     cs.ITEMS),
        "item_bias": (item_rows, torch.randn(len(item_rows), device=dev,
                                             generator=gen), cs.ITEMS)}
    out = {"card": card, "distinct_rows": {
        t: int(torch.unique(r).numel()) for t, (r, _, _) in cases.items()}}
    out["max_abs_err"] = check_sums(cases)
    print(f"sums within 1e-5 of scale of float64, two calls bit-equal: "
          f"{out['max_abs_err']}; distinct rows {out['distinct_rows']}",
          flush=True)
    res: dict = {}
    try:
        for name in TURNS:
            optim.dedup_rows = DESIGNS[name]
            turn = {}
            for table, (rows, grads, drop) in cases.items():
                def call():
                    return DESIGNS[name](rows, grads, drop)
                turn[f"{table} device_ms"] = cs.device_ms(call)
                turn[f"{table} event_ms"] = cs.time_ms(call)
                turn[f"{table} kernels"] = kernels_per_call(call)

            def step():
                return model.train_step(batch)
            turn["step device_ms"] = cs.device_ms(step)
            turn["step event_ms"] = cs.time_ms(step)
            turn["step back_to_back_ms"] = cs.launches_ms(step)
            turn["step kernels"] = kernels_per_call(step)
            turn["epoch s"] = cs.timed(lambda: model._train_epoch(2))[1]
            print(f"{name}: {turn}  [{card}]", flush=True)
            for key, value in turn.items():
                res.setdefault(name, {}).setdefault(key, []).append(value)
        for name in DESIGNS:
            optim.dedup_rows = DESIGNS[name]
            start = cs.cpu_copy(model._train_state())
            model._train_epoch(3)
            first = cs.flat(cs.cpu_copy(model._train_state()))
            model._load_train_state(start)
            model._train_epoch(3)
            again = cs.flat(cs.cpu_copy(model._train_state()))
            cs.require(cs.bit_equal_states(first, again),
                       f"{name}: two runs of one epoch differ")
            print(f"{name}: one epoch run twice from one state, bit-equal",
                  flush=True)
    finally:
        optim.dedup_rows = DESIGNS["segment_reduce"]
    out["turns"] = res
    for name, turn in res.items():
        print(f"{name} mean of its turns: "
              f"{ {k: float(np.mean(v)) for k, v in turn.items()} }  "
              f"[{card}]")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "dedup_rows_designs.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
