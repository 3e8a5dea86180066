"""Variants of the propagation kernel's merge pass, timed against the
package's kernel and the parent's two-launch pair on one card.

Usage, from the root of a checkout, on a machine with a card (the parent's
sources unpacked as for ``chip_ab.py``):

    python3 experiments/segsum_merge_variants.py \
        --parent build/parent/skrx_torch/ops/kernels/csrc

The package's ``csrc/segsum.cu`` merges a row of several segments in the
launch that computes it (the last warp to finish such a row adds its
partials), holds the kernel to 32 registers, and ``build_segments`` puts
those rows' segments first. Each variant undoes one of those choices by a
text change of the source (:func:`variant_sources`) or of the layout
(``chip_ab.row_order``, the segments in row order):

- "uncapped": no register cap (the compiler takes 40 at D=64);
- "acq_rel": the two fences replaced by one acquire-release atomic;
- "merge 8": 8 partial-row floats a lane in flight instead of 16;
- "row order": the package's kernel on the segments in row order;
- "uncapped, row order": both, the first form of the design.

On the LightGCN graph of ``chip_ab.py`` (D=64, forward, f32 and bf16
messages, with and without a 0.8 dropout mask) every variant's output must
equal the parent pair's bit for bit; then all are timed in turns (each
name, then the names in reverse) by device time. Prints one line per
case with the card's name, power limit and SM clock, writes
``chiprun_out/segsum_merge_variants.json``; exits 2 without CUDA.
"""
import argparse
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

SOURCE = os.path.join(ROOT, "skrx_torch", "ops", "kernels", "csrc",
                      "segsum.cu")
CAPPED = "__launch_bounds__(kThreads, 2048 / kThreads)"
FENCE_1 = ("  __threadfence();                   "
           "// each lane's stores before the count\n")
FENCE_2 = ("  __threadfence();                   "
           "// the count before the partials' loads\n")
COUNT = ("  if (lane == 0) last = atomicAdd(merge_count + m, 1) == "
         "p1 - p0 - 1;\n")
ACQ_REL = """  if (lane == 0) {
    int old;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;"
                 : "=r"(old) : "l"(merge_count + m) : "memory");
    last = old == p1 - p0 - 1;
  }
"""
MERGE_16 = "constexpr int kMergeFloats = 16;"


def variant_sources(text: str) -> dict:
    """{variant: source} made from the package's segsum.cu; raises if a
    piece of text a variant changes is not there exactly once."""
    for piece in (CAPPED, FENCE_1, FENCE_2, COUNT, MERGE_16):
        if text.count(piece) != 1:
            raise ValueError(f"segsum.cu has no single {piece.strip()!r}")
    return {
        "uncapped": text.replace(CAPPED, "__launch_bounds__(kThreads)"),
        "acq_rel": text.replace(FENCE_1, "").replace(COUNT, ACQ_REL)
                       .replace(FENCE_2, "  __syncwarp();\n"),
        "merge 8": text.replace(MERGE_16, MERGE_16.replace("16", "8")),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="directory with the parent's segsum.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("segsum_merge_variants: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    out_dir = os.path.join(ROOT, "build", "segsum_merge_variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(SOURCE) as f:
        srcs = {}
        for name, text in variant_sources(f.read()).items():
            path = os.path.join(out_dir, name.replace(" ", "_") + ".cu")
            with open(path, "w") as g:
                g.write(text)
            srcs[name] = path
    srcs["new"] = SOURCE
    srcs["parent"] = os.path.join(args.parent, "segsum.cu")
    libs, logs = ab.build(srcs, out_dir)
    for name, log in logs.items():
        entry = ""
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = line
            elif "registers" in line and "ILi2ELi1ELb0E" in entry:
                print(f"ptxas {name} (D=64, f32): {line.strip()}")

    root = os.path.join(ROOT, "build", "segsum_merge_variants_data")
    shutil.rmtree(root, ignore_errors=True)
    path = synthetic.make_dataset_dir(root, num_users=ab.USERS,
                                      num_items=ab.ITEMS,
                                      num_ratings=ab.RATINGS, seed=ab.SEED)
    reg = ModelRegistry()
    reg.load_skrx_model("LightGCN")
    gcn = reg.get_model("LightGCN")[0](
        RunConfig(recommender="LightGCN", data_dir=path, seed=ab.SEED),
        {"epochs": 1})
    seg = gcn.graph.fwd
    rows = ab.row_order(seg)
    x = torch.cat([gcn.user_emb, gcn.item_emb]).detach().contiguous()
    keep = torch.rand(gcn.graph.num_edges, device=dev,
                      generator=torch.Generator(dev).manual_seed(ab.SEED))
    drop = (keep < 0.8).float() / 0.8
    d, nseg = ab.DIM, seg.seg_dst.shape[0]
    out = torch.empty((seg.num_nodes, d), device=dev)
    partial = torch.empty((seg.num_partials, d), device=dev)
    p = ab.ptr
    parent = ab.c_fn(libs["parent"], srcs["parent"], "skrx_segsum")
    merge = ab.c_fn(libs["parent"], srcs["parent"], "skrx_segsum_merge")
    runs = {"new": ("new", seg), "uncapped": ("uncapped", seg),
            "acq_rel": ("acq_rel", seg), "merge 8": ("merge 8", seg),
            "row order": ("new", rows),
            "uncapped, row order": ("uncapped", rows)}
    results = {"card": card}
    for msg, bf16 in (("f32", 0), ("bf16", 1)):
        for tag, m in (("no mask", None), ("dropout 0.8", drop)):
            def run_parent(m=m, bf16=bf16):
                parent(p(x), d, p(rows.seg_ptr), p(rows.seg_dst), nseg,
                       p(rows.src), p(rows.weight), p(rows.orig), p(m), bf16,
                       p(out), p(partial))
                merge(p(partial), d, p(rows.merge_row), p(rows.merge_ptr),
                      seg.merge_row.shape[0], p(out))

            def runner(lib, s, m=m, bf16=bf16):
                fn = ab.c_fn(libs[lib], srcs[lib], "skrx_segsum")
                return lambda: fn(
                    p(x), d, p(s.seg_ptr), p(s.seg_dst), nseg, p(s.src),
                    p(s.weight), p(s.orig), p(m), bf16, p(out), p(partial),
                    p(s.part_merge), p(s.merge_row), p(s.merge_ptr),
                    p(s.merge_count))
            fns = {"parent pair": run_parent}
            fns.update({name: runner(*how) for name, how in runs.items()})
            run_parent()
            ref = out.clone()
            for name in runs:
                out.zero_()
                fns[name]()
                torch.cuda.synchronize()
                if not (torch.equal(out.view(torch.int32),
                                    ref.view(torch.int32))
                        and not seg.merge_count.any()):
                    raise AssertionError(f"{name} {msg} {tag}: not the "
                                         "parent pair's bits")
            names = list(fns)
            times = ab.in_turns(fns, names + names[::-1])
            results[f"{msg} {tag}"] = times
            print(f"A, {msg}, {tag} (== parent bit for bit): " + ", ".join(
                f"{k} {np.mean(v)} ms {v}" for k, v in times.items())
                + f"  [{card}; SM clock {ab.sm_clock()}]", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "segsum_merge_variants.json"), "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
