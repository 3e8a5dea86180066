"""Host time of the serving rank tail on one card: one ``blockwise_topk``
call at B = 1 and B = 64 (N = 40,981, k = 10, the users' seen rows as the
mask), ``TopKRecommender.recommend`` p50 at B = 1 beside the p50 of its
parts (``predict`` and ``blockwise_topk`` at B = 1, each ended by a sync),
and where the tree has ``export_program``, one call of the loaded exported
tail and of ``RankTail`` at B = 64.

Usage, from the root of a checkout, on a machine with a card:

    python3 experiments/host_call_times.py [--trees DIR [DIR ...]]

Each tree (default: this checkout; another one is a directory holding its
``skrx_torch``, e.g. a parent unpacked by ``git archive``) is measured in a
process of its own that imports that tree's ``skrx_torch``, in turns: the
trees in the order given, then in reverse (A B B A for two), so that a
drift of the host shows. The data (Gowalla's counts: 29,858 users, 40,981
items, 1,027,370 interactions, this checkout's catalog-scale generator,
seed 2021) is written once under ``build/host_call_times/``; BPRMF at its
defaults (n_dim 64, weights from the seed) serves it.

A call's host time is ``time.perf_counter`` over CALLS calls ended by one
``torch.cuda.synchronize()``: the launches queue, so it is the larger of
the host's and the card's time a call. ``recommend`` returns numpy, so
each of its calls ends in a sync; its p50 is over REQUESTS single users.
"""
import argparse
import io
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "build", "host_call_times")
USERS, ITEMS, RATINGS, K, SEED = 29_858, 40_981, 1_027_370, 10, 2021
CALLS = 1000
REQUESTS = 300
WARM = 20


def host_us_per_call(fn, calls: int = CALLS) -> float:
    """Host microseconds a call of ``fn()`` over ``calls`` calls ended by
    one device sync, after WARM calls."""
    import torch
    for _ in range(WARM):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def p50_ms(fn, calls: int = REQUESTS) -> float:
    """p50 milliseconds of ``fn()`` ended by a device sync, after WARM
    calls."""
    import numpy as np
    import torch
    times = []
    for _ in range(WARM + calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times[WARM:])) * 1e3


def recommend_p50_ms(server, users) -> float:
    """p50 milliseconds of ``server.recommend([u])`` over ``users``."""
    import numpy as np
    for u in users[:WARM]:
        server.recommend([u])
    times = []
    for u in users:
        t0 = time.perf_counter()
        server.recommend([u])
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def measure(server, rng) -> dict:
    """The host times of one tree's server (module docstring)."""
    import torch
    from skrx_torch.ops.kernels import topk_blocks as tb
    out = {}
    for b in (1, 64):
        u = torch.as_tensor(rng.integers(0, USERS, b), device=server.device)
        scores = server.model.predict(u).to(torch.float32)
        mask = server._seen[u]
        out[f"blockwise_topk_B{b}_us"] = host_us_per_call(
            lambda: tb.blockwise_topk(scores, K, mask_table=mask))
    out["recommend_B1_p50_ms"] = recommend_p50_ms(
        server, rng.integers(0, USERS, REQUESTS))
    u = torch.as_tensor(rng.integers(0, USERS, 1), device=server.device)
    scores, mask = server.model.predict(u).to(torch.float32), server._seen[u]
    out["predict_B1_p50_ms"] = p50_ms(lambda: server.model.predict(u))
    out["blockwise_topk_B1_p50_ms"] = p50_ms(
        lambda: tb.blockwise_topk(scores, K, mask_table=mask))
    if hasattr(server, "export_program"):
        program = torch.export.load(io.BytesIO(server.export_program(64)))
        run = program.module()
        u = torch.as_tensor(rng.integers(0, USERS, 64), device=server.device)
        scores = server.model.predict(u).to(torch.float32)
        seen = server._seen[u]
        out["loaded_program_B64_us"] = host_us_per_call(
            lambda: run(scores, seen))
        out["rank_tail_B64_us"] = host_us_per_call(
            lambda: server.rank_tail(scores, seen))
    return out


def worker(tree: str, data: str) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    from skrx_torch import ModelRegistry, RunConfig
    from skrx_torch.serve import TopKRecommender
    import skrx_torch
    assert os.path.dirname(os.path.dirname(skrx_torch.__file__)) == \
        os.path.abspath(tree), skrx_torch.__file__
    reg = ModelRegistry()
    reg.load_skrx_model("BPRMF")
    cls, _ = reg.get_model("BPRMF")
    os.chdir(WORK)                      # the model writes log/ here
    model = cls(RunConfig(recommender="BPRMF", data_dir=data, seed=SEED),
                {"n_dim": 64})
    server = TopKRecommender(model, k=K)
    with torch.no_grad():
        rec = measure(server, np.random.default_rng(SEED + 7))
    rec["tree"] = tree
    print(json.dumps(rec), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--worker", nargs=2, metavar=("TREE", "DATA"))
    args = ap.parse_args(argv)
    if args.worker:
        worker(*args.worker)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("host_call_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from skrx_torch.io import synthetic
    from skrx_torch.utils.chip import card_line
    os.makedirs(WORK, exist_ok=True)
    data = synthetic.make_dataset_dir(WORK, num_users=USERS, num_items=ITEMS,
                                      num_ratings=RATINGS, seed=SEED)
    card = card_line()
    turns = args.trees + args.trees[::-1]
    by_tree = {}
    for tree in turns:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree,
             data], capture_output=True, text=True, cwd=ROOT, timeout=900)
        if out.returncode:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"{json.dumps(rec)}  [{card}]", flush=True)
        by_tree.setdefault(tree, []).append(rec)
    for tree, recs in by_tree.items():
        keys = [k for k in recs[0] if k != "tree"]
        means = {k: sum(r[k] for r in recs) / len(recs) for k in keys}
        print(f"{tree}: mean of {len(recs)} turns {json.dumps(means)}  "
              f"[{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
