"""Designs of a row sum in batch order (``skrx_torch.ops.scatter.
ordered_row_sum``: the rows of ``grads`` summed into ``n_rows`` rows by
``ids``, repeated ids in one fixed order) timed against each other and
against the unordered ``index_add_`` on one card.

Usage, from the root of a checkout, on a machine with a card:

    python3 experiments/ordered_row_sum_designs.py

"index_put" is ``out.index_put_((ids,), grads, accumulate=True)``: the ids
sorted by a stable radix sort and each run of equal ids summed by one warp
(in batch order for rows of over 32 features, by a fixed warp tree for
1-D tables). "segment_reduce" is lazy Adam's ``dedup_rows`` (a stable sort,
the runs' lengths by ``scatter_add_``, one ``torch.segment_reduce``)
followed by an ``index_copy_`` of the distinct rows into ``n_rows``.
"pieces" is the package's sum above ``PUT_ROWS`` rows
(``scatter.sum_in_pieces``): the same sort, each run cut into pieces of at
most 128 rows, and two ``torch.segment_reduce`` calls (the pieces, then
each run's pieces). "index_add" is ``index_add_``, whose card
implementation adds through atomics in no fixed order (what
``index_select``'s gradient does).

The cases are the gathers on the train path at the JAX package's default
widths over the Gowalla-scale catalog (40,981 items, d = 64), ids drawn
from a Zipf law (exponent 1.1) with the padding share the models see:
GRU4Rec's 128 targets and GRU4RecPlus's 2,176 (targets and 2,048 sampled
negatives), each for the (N, 64) table and the (N,) bias; SASRec's 128 x 50
sequence ids (a third of them the pad row); BERT4Rec's 256 x 5 tokens;
SRGNN's 256 x 200 session nodes (four in five the pad row); the 2,048
rows of a multimodal batch; and a hub, 65,536 ids of which half are one
row. For each case and design: the sum against float64 (within 1e-5 of
the largest summed magnitude), the bits of two calls (equal or not), and,
in turns (index_put, segment_reduce, pieces, pieces, segment_reduce,
index_put, then index_add), the time of one call between CUDA events (median of 50) and
the device time per call (torch.profiler). Prints one line per case with
the card's name and power limit and writes
``chiprun_out/ordered_row_sum_designs.json``; exits 2 without CUDA.
"""
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N, D = 40_981, 64
# name -> (ids shape, feature width or None for a 1-D table, pad share)
CASES = {
    "GRU4Rec item_emb": ((128,), D, 0.0),
    "GRU4Rec item_bias": ((128,), None, 0.0),
    "GRU4RecPlus item_emb": ((2_176,), D, 0.0),
    "GRU4RecPlus item_bias": ((2_176,), None, 0.0),
    "SASRec sequence": ((128, 50), D, 1 / 3),
    "BERT4Rec tokens": ((256, 5), D, 0.0),
    "SRGNN nodes": ((256, 200), D, 0.8),
    "multimodal batch": ((2_048,), D, 0.0),
    "hub": ((65_536,), D, 0.5),
}


def by_index_put(ids, grads, n_rows):
    out = grads.new_zeros((n_rows, *grads.shape[1:]))
    return out.index_put_((ids,), grads, accumulate=True)


def by_segment_reduce(ids, grads, n_rows):
    from skrx_torch.ops.optim import dedup_rows
    unique, summed = dedup_rows(ids, grads, n_rows)
    out = grads.new_zeros((n_rows + 1, *grads.shape[1:]))
    return out.index_copy_(0, unique, summed)[:n_rows]


def by_pieces(ids, grads, n_rows):
    from skrx_torch.ops.scatter import sum_in_pieces
    return sum_in_pieces(ids, grads, n_rows)


def by_index_add(ids, grads, n_rows):
    out = grads.new_zeros((n_rows, *grads.shape[1:]))
    return out.index_add_(0, ids, grads)


DESIGNS = {"index_put": by_index_put, "segment_reduce": by_segment_reduce,
           "pieces": by_pieces, "index_add": by_index_add}
TURNS = ("index_put", "segment_reduce", "pieces", "pieces", "segment_reduce",
         "index_put", "index_add")


def case_inputs(rng, shape, width, pad):
    k = int(np.prod(shape))
    ids = (rng.zipf(1.1, k) - 1) % N
    if pad:
        ids[rng.random(k) < pad] = N - 1
    if shape == (65_536,):
        ids[: k // 2] = 7
    g_shape = (k,) if width is None else (k, width)
    grads = rng.standard_normal(g_shape).astype(np.float32)
    return ids, grads


def main() -> int:
    if not torch.cuda.is_available():
        print("ordered_row_sum_designs: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    card = cs.card_line()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2021)
    record = {"card": card, "cases": {}}
    for name, (shape, width, pad) in CASES.items():
        ids_np, g_np = case_inputs(rng, shape, width, pad)
        ref = np.zeros((N,) + g_np.shape[1:])
        np.add.at(ref, ids_np, g_np.astype(np.float64))
        scale = float(np.abs(ref).max())
        ids = torch.as_tensor(ids_np, device=dev)
        grads = torch.as_tensor(g_np, device=dev)
        row = {"ids": int(ids_np.size), "distinct": int(len(np.unique(
            ids_np))), "largest_run": int(np.bincount(ids_np).max())}
        for dname, fn in DESIGNS.items():
            a = fn(ids, grads, N)
            b = fn(ids, grads, N)
            err = float(np.abs(a.double().cpu().numpy() - ref).max())
            row[dname] = {"err": err, "within": err <= 1e-5 * scale,
                          "bit_equal_twice": bool(torch.equal(
                              a.view(torch.int32), b.view(torch.int32)))}
        for turn, dname in enumerate(TURNS):
            fn = DESIGNS[dname]
            row[dname][f"ms_turn{turn}"] = cs.time_ms(
                lambda: fn(ids, grads, N), 50)
            row[dname][f"device_ms_turn{turn}"] = cs.device_ms(
                lambda: fn(ids, grads, N), 50)
        record["cases"][name] = row
        print(f"{name} ({row['ids']} ids, {row['distinct']} distinct, "
              f"largest run {row['largest_run']}, width "
              f"{width or 1}): " + "; ".join(
                  f"{d} {row[d]}" for d in DESIGNS) + f"  [{card}]",
              flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "ordered_row_sum_designs.json"), "w") as f:
        json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
