"""Time the port's redesigned kernels against a parent's sources on one card.

Usage, from the root of a checkout, on a machine with a card:

    mkdir -p build/parent
    git archive <parent> skrx_torch/ops/kernels/csrc | tar -x -C build/parent
    python3 chip_ab.py --parent build/parent/skrx_torch/ops/kernels/csrc

``--parent`` names a directory holding the parent's ``segsum.cu`` and
``topk_blocks.cu`` (keep it under ``build/``, which git ignores). The script
builds them with nvcc beside this tree's kernels and calls each of their C
launchers with the argument types of its own C declaration
(:func:`c_argtypes`), so the parent's signatures need not be this tree's;
this tree's kernels run through the package's wrappers, as a user calls
them. Every time is device time
per call (``chip_smoke.device_ms``: torch.profiler, the summed durations of
the kernels a call launches, over 50 calls after warm-up), so a kernel
shorter than a host launch is not timed by the host's launch rate. On the
synthetic Gowalla-scale data of ``chip_smoke.py`` (seed 2021) it then:

1. propagation on the LightGCN graph (D=64), forward (A) and backward
   (A^T), f32 and bf16 messages, with and without a 0.8 dropout mask: this
   tree's segsum (one launch; the last warp to finish a row of several
   segments merges it; such rows' segments first) against the parent's
   pair (``skrx_segsum``, then ``skrx_segsum_merge`` on its partial rows)
   on its own layout (:func:`row_order`), the outputs equal bit for bit,
   then timed in turns: parent, new, new, parent;
2. extract at the evaluation shape (B=64 test users, k=50, the evaluator's
   train table) and the serving shape (B=1,024 users, k=10, the seen
   table), on BPRMF's scores and the tau of submax + kth_largest: first the
   distribution of ``found`` per (row, column block), the survivors a block
   selects from (:func:`found_stats`), then this tree's kernel and the
   parent's equal bit for bit (values as int32, ids), then timed in turns:
   parent, new, new, parent.

Prints one line per measurement with the card's name, power limit and SM
clock, and writes every number to ``chiprun_out/chip_ab.json``. Exits 2
without CUDA.
"""
import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from chip_smoke import RANK_CAP, card_line, device_ms
from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.io import synthetic
from skrx_torch.ops.kernels import _build
from skrx_torch.ops.kernels import segsum as ss
from skrx_torch.ops.kernels import topk_blocks as tb
from skrx_torch.serve import TopKRecommender

USERS, ITEMS, RATINGS, DIM, SEED = 29_858, 40_981, 1_027_370, 64, 2021
BLOCK_N = 4096


def c_argtypes(path: str, fn_name: str) -> list:
    """ctypes argument types of ``int fn_name(...)`` as ``path`` declares it
    at the start of a line: c_void_p for a pointer or the stream, c_int
    otherwise."""
    with open(path) as f:
        decls = dict(re.findall(r"^int (skrx_\w+)\(([^)]*)\)", f.read(), re.M))
    if fn_name not in decls:
        raise KeyError(f"{path} declares no {fn_name}")
    return [ctypes.c_void_p if "*" in p or "cudaStream_t" in p
            else ctypes.c_int for p in decls[fn_name].split(",")]


def row_order(seg: ss.Segments) -> ss.Segments:
    """The same segments in row order with their edges (CSR by destination,
    the layout before rows of several segments were put first); partial
    slots and merge tables unchanged. The parent's kernels run on it."""
    sdst = seg.seg_dst.cpu().numpy().astype(np.int64)
    slot = np.maximum(-1 - sdst, 0)
    rows = np.where(sdst >= 0, sdst, seg.merge_row.cpu().numpy()[
        seg.part_merge.cpu().numpy()[slot]] if seg.num_partials else sdst)
    order = np.lexsort((slot, rows))
    ptr = seg.seg_ptr.cpu().numpy().astype(np.int64)
    lens = np.diff(ptr)[order]
    new_ptr = np.concatenate([[0], np.cumsum(lens)])
    edges = torch.from_numpy(np.arange(ptr[-1]) - np.repeat(new_ptr[:-1], lens)
                             + np.repeat(ptr[:-1][order], lens))
    edges = edges.to(seg.src.device)
    return seg._replace(
        src=seg.src[edges], dst=seg.dst[edges], weight=seg.weight[edges],
        orig=seg.orig[edges],
        seg_ptr=torch.from_numpy(new_ptr.astype(np.int32)).to(seg.src.device),
        seg_dst=seg.seg_dst[torch.from_numpy(order).to(seg.src.device)])


def found_stats(scores: torch.Tensor, mask, tau: torch.Tensor, k: int,
                block_n: int = BLOCK_N) -> dict:
    """The survivors extract selects from in each (row, column block): the
    finite unmasked scores >= the row's tau, counted from the plain masked
    matrix. Their mean and largest count, and the share of blocks with none,
    with at most 32, with at least k and with more than RANK_CAP."""
    b = scores.shape[0]
    s = tb._masked_padded(scores, mask, block_n).reshape(b, -1, block_n)
    found = ((s >= tau[:, None, None]) & (s != float("-inf"))).sum(2)
    found = found.double().flatten()
    return {"blocks": int(found.numel()), "mean": float(found.mean()),
            "max": int(found.max()),
            "share_0": float((found == 0).double().mean()),
            "share_le_32": float((found <= 32).double().mean()),
            "share_ge_k": float((found >= k).double().mean()),
            "share_gt_cap": float((found > RANK_CAP).double().mean())}


def build(jobs: dict, out_dir: str):
    """{name: source} -> ({name: loaded library}, {name: nvcc's output}),
    one nvcc each, all started together."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, src in jobs.items():
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs, logs = {}, {}
    for name, (proc, lib) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{logs[name]}")
        libs[name] = ctypes.CDLL(lib)
    return libs, logs


def c_fn(lib, source: str, name: str):
    """The launcher ``name`` of ``lib``, typed from ``source``; raises on a
    CUDA error."""
    fn = getattr(lib, name)
    fn.argtypes = c_argtypes(source, name)
    fn.restype = ctypes.c_int

    def call(*args):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return call


def sm_clock() -> str:
    """The card's SM clock now, as nvidia-smi reads it."""
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def ptr(t):
    return None if t is None else t.data_ptr()


def in_turns(fns: dict, order) -> dict:
    """{name: [ms of each turn]} timing fns in the given order of names."""
    times = {name: [] for name in fns}
    for name in order:
        times[name].append(device_ms(fns[name]))
    return times


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="directory with the parent's segsum.cu and "
                    "topk_blocks.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    src = {"parent_segsum": os.path.join(args.parent, "segsum.cu"),
           "parent_topk": os.path.join(args.parent, "topk_blocks.cu")}
    t0 = time.perf_counter()
    libs, logs = build(src, os.path.join(here, "build", "chip_ab"))
    _build.load("segsum")                     # builds every csrc/*.cu
    print(f"built {sorted(libs)} and this tree's kernels in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    logs.update(_build.build_info().get("log", {}))
    for stem, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"  ptxas {stem}: {line.strip()}")
    results = {"card": card}

    def report(what: str, times: dict) -> None:
        results[what] = times
        print(f"{what} (== parent bit for bit): " + ", ".join(
            f"{k} {np.mean(v)} ms {v}" for k, v in times.items())
            + f"  [{card}; SM clock after the turns {sm_clock()}]", flush=True)

    # ------------------------------------------------------------ data
    root = os.path.join(here, "build", "chip_ab_data")
    shutil.rmtree(root, ignore_errors=True)
    path = synthetic.make_dataset_dir(root, num_users=USERS, num_items=ITEMS,
                                      num_ratings=RATINGS, seed=SEED)
    reg = ModelRegistry()
    reg.load_skrx_model("BPRMF")
    reg.load_skrx_model("LightGCN")
    bpr_cls, _ = reg.get_model("BPRMF")
    gcn_cls, _ = reg.get_model("LightGCN")
    bpr = bpr_cls(RunConfig(recommender="BPRMF", data_dir=path, seed=SEED),
                  {"n_dim": DIM, "epochs": 1})
    gcn = gcn_cls(RunConfig(recommender="LightGCN", data_dir=path,
                            seed=SEED), {"epochs": 1})

    # ----------------------------------------------------- propagation
    parent_segsum = c_fn(libs["parent_segsum"], src["parent_segsum"],
                         "skrx_segsum")
    parent_merge = c_fn(libs["parent_segsum"], src["parent_segsum"],
                        "skrx_segsum_merge")
    graph = gcn.graph
    ego = torch.cat([gcn.user_emb, gcn.item_emb]).detach().contiguous()
    keep = torch.rand(graph.num_edges, device=dev,
                      generator=torch.Generator(dev).manual_seed(SEED)) < 0.8
    drop = keep.float() / 0.8
    for direction in ("fwd", "bwd"):
        seg = getattr(graph, direction)
        pseg = row_order(seg)
        nseg, n_merge = seg.seg_dst.shape[0], seg.merge_row.shape[0]
        out = torch.empty((seg.num_nodes, DIM), device=dev)
        partial = torch.empty((seg.num_partials, DIM), device=dev)
        print(f"{direction}: {seg.num_nodes} rows, {nseg} segments, {n_merge} "
              f"rows merged from {seg.num_partials} partials, largest "
              f"in-degree {seg.max_degree}", flush=True)
        for msg, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            for tag, m in (("no mask", None), ("dropout 0.8", drop)):
                bf16 = int(dtype == torch.bfloat16)

                def run_parent(m=m, bf16=bf16):
                    parent_segsum(ptr(ego), DIM, ptr(pseg.seg_ptr),
                                  ptr(pseg.seg_dst), nseg, ptr(pseg.src),
                                  ptr(pseg.weight), ptr(pseg.orig), ptr(m),
                                  bf16, ptr(out), ptr(partial))
                    parent_merge(ptr(partial), DIM, ptr(pseg.merge_row),
                                 ptr(pseg.merge_ptr), n_merge, ptr(out))

                def run_new(m=m, dtype=dtype):
                    return ss.segsum(seg, ego, m, dtype)
                run_parent()
                ref = out.clone()
                for rep in range(3):        # the counters are back at 0
                    got = run_new()
                    torch.cuda.synchronize()
                    if not torch.equal(got.view(torch.int32),
                                       ref.view(torch.int32)):
                        raise AssertionError(f"segsum {direction} {msg} {tag}"
                                             f" (call {rep}): not equal to "
                                             "the parent's pair")
                    if int(seg.merge_count.abs().sum()):
                        raise AssertionError("segsum left a counter set")
                report(f"propagate {direction} {msg} {tag}",
                       in_turns({"parent": run_parent, "new": run_new},
                                ["parent", "new", "new", "parent"]))

    # --------------------------------------------------------- extract
    parent_extract = c_fn(libs["parent_topk"], src["parent_topk"],
                          "skrx_extract")
    ev = bpr.evaluator
    rng = np.random.default_rng(SEED)
    test_users = np.fromiter(ev.user_pos_test, np.int64)
    u64 = rng.choice(test_users, 64, replace=False)
    u1k = torch.as_tensor(rng.integers(0, USERS, 1024), device=dev)
    seen = TopKRecommender(bpr, k=10)._seen
    cases = {"B=64 k=50 (evaluation)": (
                 bpr.predict(u64),
                 torch.from_numpy(ev._tables_for(u64, ITEMS)[0]).to(dev), 50),
             "B=1024 k=10 (serving)": (bpr.predict(u1k), seen[u1k], 10)}
    for tag, (scores, mask, k) in cases.items():
        scores, mask = scores.contiguous(), mask.contiguous()
        b, n = scores.shape
        tau = tb.kth_largest(tb.fold_submaxes(tb.submax(scores, mask, BLOCK_N),
                                              k).contiguous(), k)
        stats = found_stats(scores, mask, tau, k)
        results[f"found {tag}"] = stats
        print(f"found per (row, block) at {tag}, L={mask.shape[1]}: {stats}",
              flush=True)
        w = -(-n // BLOCK_N) * k
        pv = torch.empty((b, w), device=dev)
        pi = torch.empty((b, w), device=dev, dtype=torch.int32)

        def run_parent():
            parent_extract(ptr(scores), b, n, BLOCK_N, ptr(mask),
                           mask.shape[1], ptr(tau), k, ptr(pv), ptr(pi))

        def run_new():
            return tb.extract(scores, tau, k, mask, BLOCK_N)
        run_parent()
        nv, ni = run_new()
        torch.cuda.synchronize()
        if not (torch.equal(pv.view(torch.int32), nv.view(torch.int32))
                and torch.equal(pi, ni)):
            raise AssertionError(f"extract {tag}: not equal to the parent's "
                                 "kernel")
        report(f"extract {tag}", in_turns({"parent": run_parent,
                                           "new": run_new},
                                          ["parent", "new", "new", "parent"]))

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", "chip_ab.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({"ok": True, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
