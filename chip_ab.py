"""Time the port's redesigned kernels against a parent's sources on one card.

Usage, from the root of a checkout, on a machine with a card:

    mkdir -p build/parent
    git archive <parent> skrx_torch/ops/kernels/csrc | tar -x -C build/parent
    python3 chip_ab.py --parent build/parent/skrx_torch/ops/kernels/csrc

``--parent`` names a directory holding the parent's ``segsum.cu``,
``topk_blocks.cu`` and ``rank_counts.cu`` (keep it under ``build/``, which
git ignores). The script builds them with nvcc beside this tree's kernels
and calls each of their C launchers with the argument types of its own C
declaration (:func:`c_argtypes`), so the parent's signatures need not be
this tree's; this tree's kernels run through the package's wrappers, as a
user calls them. Every time is device time per call
(``chip_smoke.device_ms``: torch.profiler, the summed durations of the
kernels a call launches, over 50 calls after warm-up), so a kernel shorter
than a host launch is not timed by the host's launch rate.
Each phase first holds this tree's kernel equal to the parent's bit for bit
(values as int32 views, ids and counts), then times them in turns: parent,
new, new, parent. On the synthetic Gowalla-scale data of ``chip_smoke.py``
(seed 2021), BPRMF at n_dim=64:

1. (only for a parent with the two-launch propagation, whose segsum.cu
   declares skrx_segsum_merge; skipped with a line otherwise) propagation
   on the LightGCN graph (D=64), forward (A) and backward (A^T), f32 and
   bf16 messages, with and without a 0.8 dropout mask: this tree's segsum
   (one launch; the last warp to finish a row of several segments merges
   it; such rows' segments first) against the parent's pair
   (``skrx_segsum``, then ``skrx_segsum_merge`` on its partial rows) on
   its own layout (:func:`row_order`);
2. extract at the evaluation shape (B=64 test users, k=50, the evaluator's
   train table) and the serving shape (B=1,024 users, k=10, the seen
   table), on the tau of submax + kth_largest, after the distribution of
   ``found`` per (row, column block), the survivors a block selects from
   (:func:`found_stats`);
3. pruned_merge: first which lane of a repeated (value, id) pair the
   parent writes, on ``chip_smoke.merge_rows`` against pruned_merge_plain
   (the (row, slot) where they differ); then the chunked evaluate()'s merge
   (B=64 test users, W=100, k=50, tau = -inf: the running best after the
   first 8,192-item chunk beside the second chunk's top 50,
   :func:`chunk_merge_input`) and the serving merge (B=1,024, W=110, k=10,
   the tau of submax + kth_largest), with the survivors a row there
   (:func:`merge_survivors`) and one torch.topk on the same input; then
   rows of F and F + 1 distinct survivors (F = MERGE_CAP, the most the new
   kernel ranks directly) at k = 10 and 50;
4. rank_count at the evaluation batch (B=64 test users, the candidates of
   blockwise_candidates at k=50, W=550, the evaluator's test table, T=416,
   the probes as masked_topk_ranks gives them), at B=1,024, and at B=64
   with the empty slots' ids made distinct (no two adjacent keys equal,
   the new kernel's worst case), each after the segments of equal keys a
   row (``chip_smoke.rank_segments``);
5. submax at the evaluation shape (B=64 test users, the evaluator's train
   table) and the serving shape (B=1,024 users, the seen table): equal to
   the parent's as int32 views, the (row, group) printed wherever a signed
   zero differs (:func:`sign_flips`), and equal to submax_plain;
6. rank_lookup_count on fused evaluate()'s inputs (B=64 test users, the
   candidates of dot_topk_candidates at k=50, W=550, the evaluator's test
   table as the probe ids, T=416), then the same with every empty slot
   given a distinct finite value below its row's smallest (no -inf lane:
   the new kernel's lookup list as long as the row, its worst case), each
   after the segments of equal keys and the lanes not -inf a row
   (:func:`lookup_cases`); then the NaN row, a NaN at a found probe's id
   in each row: the new kernel against rank_lookup_count_plain, and the
   (row, probe) where the parent differs from it;
7. direct_rank on evaluation batches of 64 test users with the evaluator's
   own padding of the train (mask) and test (probe) tables
   (:func:`direct_rank_cases`): MovieLens-1M scale (N=3,706, the main
   path's shape), the same rows with T cut to 128 (JAX's limit),
   MovieLens-100k scale (N=1,682), N=12,799 (the top of the route at
   k=50), and B=7 rows of N=51,000 with one probe at k=200, each after its
   found probes (m_valid, and a row's mean and largest); beside the turns,
   each kernel by CUDA events over 1,000 back-to-back calls and as the
   median of one call between events; then the ML-1M batch with NaN
   scores (each row's first probe on a NaN column): the new kernel against
   direct_rank_plain, and how many (row, probe) pairs of the parent's
   differ from it.

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

from chip_smoke import (CHUNK, MERGE_CAP, ML_ITEMS, ML_RATINGS, ML_USERS,
                        RANK_CAP, card_line, device_ms, launches_ms,
                        merge_rows, rank_segments, time_ms)
from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.io import synthetic
from skrx_torch.ops.kernels import _build
from skrx_torch.ops.kernels import dot_topk as dt
from skrx_torch.ops.kernels import segsum as ss
from skrx_torch.ops.kernels import topk_blocks as tb
from skrx_torch.ops.metrics import topk_scores_and_indices
from skrx_torch.serve import TopKRecommender

USERS, ITEMS, RATINGS, DIM, SEED = 29_858, 40_981, 1_027_370, 64, 2021
BLOCK_N = 4096


def c_declarations(path: str) -> dict:
    """{name: parameter list} of every ``int skrx_...(...)`` that ``path``
    declares at the start of a line."""
    with open(path) as f:
        return dict(re.findall(r"^int (skrx_\w+)\(([^)]*)\)", f.read(), re.M))


def c_argtypes(path: str, fn_name: str) -> list:
    """ctypes argument types of ``int fn_name(...)`` as ``path`` declares it
    at the start of a line: c_void_p for a pointer or the stream, c_int
    otherwise."""
    decls = c_declarations(path)
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


PARENT_SOURCES = {"parent_segsum": "segsum.cu",
                  "parent_topk": "topk_blocks.cu",
                  "parent_rank": "rank_counts.cu"}


def merge_survivors(vals: torch.Tensor, tau: torch.Tensor, k: int) -> dict:
    """The survivors pruned_merge lists in each row (v >= tau, v != -inf;
    repeated pairs counted each time): their mean and largest count, and
    the share of rows with at most 32, with at least k and with more than
    MERGE_CAP."""
    found = ((vals >= tau[:, None]) & (vals != float("-inf"))).sum(1)
    found = found.double()
    return {"rows": int(found.numel()), "mean": float(found.mean()),
            "max": int(found.max()),
            "share_le_32": float((found <= 32).double().mean()),
            "share_ge_k": float((found >= k).double().mean()),
            "share_gt_cap": float((found > MERGE_CAP).double().mean())}


def chunk_merge_input(model, users, train_t: torch.Tensor, k: int,
                      num_items: int, chunk: int = CHUNK):
    """(vals (B, 2k), ids): the second merge of the chunked evaluate() for
    these users, as RankingEvaluator.evaluate_chunked builds it: the running
    best after the first chunk beside the second chunk's masked top-k
    (ids offset by the chunk's start)."""
    b = len(users)
    best_v = torch.full((b, k), float("-inf"), device=train_t.device)
    best_i = torch.full((b, k), num_items + 1, dtype=torch.int32,
                        device=train_t.device)
    for lo in (0, chunk):
        hi = min(lo + chunk, num_items)
        scores = model.predict_chunk(users, lo, hi).float()
        shifted = train_t - lo
        shifted = torch.where(shifted < 0, hi - lo, shifted)
        vals, idx = topk_scores_and_indices(scores, min(k, hi - lo),
                                            mask_table=shifted)
        cat_v = torch.cat([best_v, vals], 1).contiguous()
        cat_i = torch.cat([best_i, idx + lo], 1).contiguous()
        if lo == 0:
            best_v, best_i = tb.vmem_topk(cat_v, cat_i, k)
    return cat_v, cat_i


def rank_count_cases(model, user_batches) -> list:
    """[(note, cand_v, cand_i, s_t, probes)]: rank_count's inputs as
    masked_topk_ranks gives them in an evaluation batch of each of
    ``user_batches`` (the candidates of blockwise_candidates at k=50 with
    the evaluator's train table, the test table's ids and their scores),
    then the first batch again with every empty slot's id made its own, so
    that no two adjacent candidate keys are equal."""
    ev = model.evaluator
    n = model.num_items
    cases = []
    for users in user_batches:
        tr, te, _ = ev._tables_for(users, n)
        dev = model.user_emb.device
        tr, te = (torch.from_numpy(x).to(dev) for x in (tr, te))
        scores = model.predict(users)
        cand_v, cand_i, _ = tb.blockwise_candidates(scores, 50, BLOCK_N, tr)
        safe = torch.where((te >= 0) & (te < n), te, 0).contiguous()
        s_t = scores.gather(1, safe.long()).contiguous()
        cases.append(("", cand_v, cand_i, s_t, safe))
    _, cand_v, cand_i, s_t, safe = cases[0]
    lane = torch.arange(cand_i.shape[1], device=cand_i.device,
                        dtype=torch.int32)
    cases.append((", no repeated keys", cand_v, torch.where(
        cand_i == tb.SENTINEL, tb.SENTINEL + 1 + lane, cand_i).contiguous(),
        s_t, safe))
    return cases


def sign_flips(got: torch.Tensor, ref: torch.Tensor) -> list:
    """[(row, column)] where f32 ``got`` and ``ref`` are equal as floats
    but not as int32 views: the signed zeros on which they differ."""
    got, ref = got.cpu(), ref.cpu()
    return ((got == ref) & (got.view(torch.int32) != ref.view(torch.int32))
            ).nonzero().tolist()


def lookup_cases(model, users, k: int = 50) -> list:
    """[(note, cand_v, cand_i, probes)]: rank_lookup_count's inputs in the
    fused evaluate() of these users, as RankingEvaluator.evaluate_fused
    gives them (the candidates of dot_topk_candidates at k with the
    evaluator's train table as the mask, the test table's ids as the
    probes); then the same with every empty slot (-inf) given a distinct
    finite value below its row's smallest, so that no lane is -inf (a found
    probe keeps its rank); then the NaN row: in each row the first probe
    made the id of the row's first candidate that is not -inf, and the
    first empty slot (NaN, that id), a repeated id whose looked-up score is
    NaN, so that the probe is not found and ranks 0."""
    ev = model.evaluator
    u_all, i_all = model._chunk_embeddings()
    bias = model._chunk_bias() if hasattr(model, "_chunk_bias") else None
    dev = u_all.device
    tr, te, _ = (torch.from_numpy(x).to(dev)
                 for x in ev._tables_for(users, model.num_items))
    cand_v, cand_i, _ = dt.dot_topk_candidates(
        u_all.detach()[torch.as_tensor(users, device=dev)], None, None, k, tr,
        packed=dt.pack_items(i_all.detach(), None if bias is None
                             else bias.detach()))
    probes = te.to(torch.int32).contiguous()
    cases = [("", cand_v, cand_i, probes)]
    empty = cand_v == float("-inf")
    low = torch.where(empty, float("inf"), cand_v).amin(1, keepdim=True)
    low = torch.where(torch.isfinite(low), low, 0.0)
    lane = torch.arange(1, cand_v.shape[1] + 1, device=dev)
    fill = low - lane * (low.abs() + 1.0) * 2.0 ** -12
    cases.append((", no -inf lane",
                  torch.where(empty, fill, cand_v).contiguous(), cand_i,
                  probes))
    nan_v, nan_i, nan_p = cand_v.clone(), cand_i.clone(), probes.clone()
    for r in range(cand_v.shape[0]):
        real, slot = (~empty[r]).nonzero(), empty[r].nonzero()
        if len(real) and len(slot):
            nan_p[r, 0] = cand_i[r, real[0, 0]]
            nan_v[r, slot[0, 0]] = float("nan")
            nan_i[r, slot[0, 0]] = cand_i[r, real[0, 0]]
    cases.append((", NaN row", nan_v, nan_i, nan_p))
    return cases


# (name, users, items, ratings) of the synthetic datasets whose evaluation
# batches phase 7 ranks: MovieLens-1M's and MovieLens-100k's published
# counts, and a catalog at the top of direct_rank's route at k=50 (the
# evaluator takes it while n // 128 < 2k)
DIRECT_DATA = (("ML-1M", ML_USERS, ML_ITEMS, ML_RATINGS),
               ("ML-100k", 943, 1_682, 100_000),
               ("top of the route at k=50", ML_USERS, 12_799, ML_RATINGS))


def direct_rank_cases(root: str, dev) -> list:
    """[(tag, scores, mask, probes, k)]: direct_rank's inputs in an
    evaluation batch (64 test users, BPRMF at n_dim=64 as built, seed 2021)
    of each of DIRECT_DATA, the evaluator's train table as the mask and its
    test table as the probes, both padded as the evaluator pads them (to
    the longest list of any user), k=50; the first batch (ML-1M's) again
    with T cut to 128, the most JAX's kernel takes; then 7 rows of 51,000 random scores
    with 300 random mask ids and one random probe each, k=200 (a row wider
    than any tile of the parent's)."""
    reg = ModelRegistry()
    reg.load_skrx_model("BPRMF")
    cls, _ = reg.get_model("BPRMF")
    rng = np.random.default_rng(SEED)
    cases = []
    for name, users, items, ratings in DIRECT_DATA:
        path = synthetic.make_dataset_dir(os.path.join(root, str(items)),
                                          num_users=users, num_items=items,
                                          num_ratings=ratings, seed=SEED)
        model = cls(RunConfig(recommender="BPRMF", data_dir=path, seed=SEED),
                    {"n_dim": DIM, "epochs": 1}, device=dev)
        ev = model.evaluator
        u = rng.choice(np.fromiter(ev.user_pos_test, np.int64), 64,
                       replace=False)
        tr, te, _ = ev._tables_for(u, items)
        mask, probes = (torch.from_numpy(x).to(dev) for x in (tr, te))
        scores = model.predict(u).contiguous()
        cases.append((f"{name} B=64 N={items} L={tr.shape[1]} "
                      f"T={te.shape[1]} k=50", scores, mask, probes, 50))
        if len(cases) == 1:
            cut = probes[:, :128].contiguous()
            cases.append((f"{name} B=64 N={items} L={tr.shape[1]} "
                          f"T={cut.shape[1]} k=50", scores, mask, cut, 50))
    n = 51_000
    s, table, probes = (rng.standard_normal((7, n)).astype(np.float32),
                        rng.integers(-2, n + 2, (7, 300)).astype(np.int32),
                        rng.integers(0, n, (7, 1)).astype(np.int32))
    cases.append((f"B=7 N={n} L=300 T=1 k=200",
                  *(torch.from_numpy(x).to(dev) for x in (s, table, probes)),
                  200))
    return cases


def found_probes(scores: torch.Tensor, mask: torch.Tensor,
                 probes: torch.Tensor) -> torch.Tensor:
    """(B,) the probes a row that direct_rank counts for: id in [0, N), not
    in the row's mask, score finite (the others only get k written)."""
    n = scores.shape[1]
    safe = probes.clamp(0, n - 1)
    ok = ((probes >= 0) & (probes < n)
          & torch.isfinite(scores.gather(1, safe.long())))
    return (ok & ~tb._in_rows(mask, safe)).sum(1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="directory with the parent's segsum.cu, "
                    "topk_blocks.cu and rank_counts.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    src = {name: os.path.join(args.parent, f)
           for name, f in PARENT_SOURCES.items()}
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

    def equal(what: str, got, ref) -> None:
        """Values as int32 views, ids and counts as they are."""
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            if g.dtype == torch.float32:
                g, r = g.view(torch.int32), r.view(torch.int32)
            if not torch.equal(g, r):
                raise AssertionError(f"{what}: not equal to the parent's "
                                     "kernel")

    # ------------------------------------------------------------ data
    root = os.path.join(here, "build", "chip_ab_data")
    shutil.rmtree(root, ignore_errors=True)
    path = synthetic.make_dataset_dir(root, num_users=USERS, num_items=ITEMS,
                                      num_ratings=RATINGS, seed=SEED)
    reg = ModelRegistry()
    reg.load_skrx_model("BPRMF")
    bpr_cls, _ = reg.get_model("BPRMF")
    bpr = bpr_cls(RunConfig(recommender="BPRMF", data_dir=path, seed=SEED),
                  {"n_dim": DIM, "epochs": 1})
    ev = bpr.evaluator
    rng = np.random.default_rng(SEED)
    test_users = np.fromiter(ev.user_pos_test, np.int64)
    u64 = rng.choice(test_users, 64, replace=False)
    u1k = torch.as_tensor(rng.integers(0, USERS, 1024), device=dev)
    seen = TopKRecommender(bpr, k=10)._seen

    # ----------------------------------------------------- propagation
    if "skrx_segsum_merge" not in c_declarations(src["parent_segsum"]):
        print("phase 1 skipped: the parent's segsum.cu has no two-launch "
              "propagation (skrx_segsum_merge)", flush=True)
    else:
        reg.load_skrx_model("LightGCN")
        gcn_cls, _ = reg.get_model("LightGCN")
        gcn = gcn_cls(RunConfig(recommender="LightGCN", data_dir=path,
                                seed=SEED), {"epochs": 1})
        parent_segsum = c_fn(libs["parent_segsum"], src["parent_segsum"],
                             "skrx_segsum")
        parent_merge = c_fn(libs["parent_segsum"], src["parent_segsum"],
                            "skrx_segsum_merge")
        graph = gcn.graph
        ego = torch.cat([gcn.user_emb, gcn.item_emb]).detach().contiguous()
        keep = torch.rand(graph.num_edges, device=dev,
                          generator=torch.Generator(dev).manual_seed(SEED)
                          ) < 0.8
        drop = keep.float() / 0.8
        for direction in ("fwd", "bwd"):
            seg = getattr(graph, direction)
            pseg = row_order(seg)
            nseg, n_merge = seg.seg_dst.shape[0], seg.merge_row.shape[0]
            out = torch.empty((seg.num_nodes, DIM), device=dev)
            partial = torch.empty((seg.num_partials, DIM), device=dev)
            print(f"{direction}: {seg.num_nodes} rows, {nseg} segments, "
                  f"{n_merge} rows merged from {seg.num_partials} partials, "
                  f"largest in-degree {seg.max_degree}", flush=True)
            for msg, dtype in (("f32", torch.float32),
                               ("bf16", torch.bfloat16)):
                for tag, m in (("no mask", None), ("dropout 0.8", drop)):
                    bf16 = int(dtype == torch.bfloat16)

                    def run_parent(m=m, bf16=bf16):
                        parent_segsum(ptr(ego), DIM, ptr(pseg.seg_ptr),
                                      ptr(pseg.seg_dst), nseg, ptr(pseg.src),
                                      ptr(pseg.weight), ptr(pseg.orig),
                                      ptr(m), bf16, ptr(out), ptr(partial))
                        parent_merge(ptr(partial), DIM, ptr(pseg.merge_row),
                                     ptr(pseg.merge_ptr), n_merge, ptr(out))

                    def run_new(m=m, dtype=dtype):
                        return ss.segsum(seg, ego, m, dtype)
                    run_parent()
                    ref = out.clone()
                    for rep in range(3):    # the counters are back at 0
                        equal(f"segsum {direction} {msg} {tag} (call {rep})",
                              [run_new()], [ref])
                        if int(seg.merge_count.abs().sum()):
                            raise AssertionError("segsum left a counter set")
                    report(f"propagate {direction} {msg} {tag}",
                           in_turns({"parent": run_parent, "new": run_new},
                                    ["parent", "new", "new", "parent"]))

    # --------------------------------------------------------- extract
    parent_extract = c_fn(libs["parent_topk"], src["parent_topk"],
                          "skrx_extract")
    select_cases = {"B=64 k=50 (evaluation)": (
                        bpr.predict(u64),
                        torch.from_numpy(ev._tables_for(u64, ITEMS)[0]).to(dev),
                        50),
                    "B=1024 k=10 (serving)": (bpr.predict(u1k), seen[u1k],
                                              10)}
    for tag, (scores, mask, k) in select_cases.items():
        scores, mask = scores.contiguous(), mask.contiguous()
        b, n = scores.shape
        tau = tb.kth_largest(tb.fold_submaxes(
            tb.submax(scores, mask, BLOCK_N), k).contiguous(), k)
        stats = found_stats(scores, mask, tau, k)
        results[f"found {tag}"] = stats
        print(f"found per (row, block) at {tag}, L={mask.shape[1]}: "
              f"{stats}", flush=True)
        w = -(-n // BLOCK_N) * k
        pv = torch.empty((b, w), device=dev)
        pi = torch.empty((b, w), device=dev, dtype=torch.int32)

        def run_parent():
            parent_extract(ptr(scores), b, n, BLOCK_N, ptr(mask),
                           mask.shape[1], ptr(tau), k, ptr(pv), ptr(pi))

        def run_new():
            return tb.extract(scores, tau, k, mask, BLOCK_N)
        run_parent()
        equal(f"extract {tag}", run_new(), [pv, pi])
        report(f"extract {tag}", in_turns(
            {"parent": run_parent, "new": run_new},
            ["parent", "new", "new", "parent"]))

    # ---------------------------------------------------- pruned_merge
    parent_pm = c_fn(libs["parent_topk"], src["parent_topk"],
                     "skrx_pruned_merge")

    def merge_fns(vals, ids, tau, k):
        b, w = vals.shape
        pv = torch.empty((b, k), device=dev)
        pi = torch.empty((b, k), device=dev, dtype=torch.int32)

        def run_parent():
            parent_pm(ptr(vals), ptr(ids), b, w, ptr(tau), k, ptr(pv),
                      ptr(pi))
            return pv, pi

        def run_new():
            return tb.pruned_merge(vals, ids, k, tau)
        return run_parent, run_new

    # which lane of a repeated (value, id) pair the parent writes:
    # pruned_merge_plain (and the new kernel) write the lowest lane's
    for k in (10, 50):
        vals, ids, tau, founds = merge_rows(np.random.default_rng(k), k)
        cpu = [torch.from_numpy(x) for x in (vals, ids, tau)]
        run_parent, run_new = merge_fns(*(x.to(dev) for x in cpu), k)
        ref = tb.pruned_merge_plain(cpu[0], cpu[1], k, cpu[2])
        got = [x.cpu() for x in run_parent()]
        bad = ((got[0].view(torch.int32) != ref[0].view(torch.int32))
               | (got[1] != ref[1])).nonzero().tolist()
        results[f"parent vs plain, merge_rows k={k}"] = bad
        print(f"parent pruned_merge on merge_rows k={k} (survivors "
              f"{founds}, then repeated pairs below and above F, NaN): "
              f"(row, slot) where its values (as int32) or ids differ "
              f"from pruned_merge_plain: {bad}"
              + "".join(f"; row {r} slot {q}: parent ({got[0][r, q]}, "
                        f"{got[1][r, q]}), plain ({ref[0][r, q]}, "
                        f"{ref[1][r, q]})" for r, q in bad[:4]),
              flush=True)
    tr64 = torch.from_numpy(ev._tables_for(u64, ITEMS)[0]).to(dev)
    c_v, c_i = chunk_merge_input(bpr, u64, tr64, 50, ITEMS)
    s1k, m1k = bpr.predict(u1k), seen[u1k]
    cv, ci, tau1k = tb.blockwise_candidates(s1k, 10, BLOCK_N, m1k)
    stats = merge_survivors(cv, tau1k, 10)
    results["merge survivors B=1024 k=10"] = stats
    print(f"survivors a row at the serving merge (B=1,024, W="
          f"{cv.shape[1]}, k=10): {stats}", flush=True)
    neg = torch.full((64,), float("-inf"), device=dev)
    cases = {f"B=64 W={c_v.shape[1]} k=50 (chunked merge)":
                 (c_v, c_i, neg, 50),
             f"B=1024 W={cv.shape[1]} k=10 (serving)": (cv, ci, tau1k, 10)}
    for tag, (vals, ids, tau, k) in cases.items():
        run_parent, run_new = merge_fns(vals, ids, tau, k)
        equal(f"pruned_merge {tag}", run_new(),
              [x.clone() for x in run_parent()])
        times = in_turns({"parent": run_parent, "new": run_new},
                         ["parent", "new", "new", "parent"])
        times["torch.topk"] = [device_ms(
            lambda: torch.topk(vals, k, dim=1))]
        report(f"pruned_merge {tag}", times)
    # F: rows whose every candidate survives, at F and F + 1 (the
    # rounds) distinct pairs
    for k in (10, 50):
        for w in (MERGE_CAP, MERGE_CAP + 1):
            vals = torch.randn((64, w), device=dev,
                               generator=torch.Generator(dev).manual_seed(
                                   SEED + w))
            ids = torch.argsort(torch.rand((64, w), device=dev), 1).to(
                torch.int32)
            run_parent, run_new = merge_fns(vals, ids, neg, k)
            equal(f"pruned_merge W={w} k={k}", run_new(),
                  [x.clone() for x in run_parent()])
            report(f"pruned_merge B=64 W={w} k={k}, all survive",
                   in_turns({"parent": run_parent, "new": run_new},
                            ["parent", "new", "new", "parent"]))

    # ------------------------------------------------------ rank_count
    parent_rc = c_fn(libs["parent_rank"], src["parent_rank"],
                     "skrx_rank_count")
    cases = rank_count_cases(
        bpr, [u64, rng.choice(test_users, 1024, replace=False)])
    for note, cand_v, cand_i, s_t, safe in cases:
        b, w = cand_v.shape
        t = safe.shape[1]
        out = torch.empty((b, t), device=dev, dtype=torch.int32)
        segs = rank_segments(cand_v, cand_i).double()
        print(f"rank_count B={b}{note}: segments of equal keys a row, "
              f"mean {float(segs.mean())}, max {int(segs.max())}",
              flush=True)

        def run_parent():
            parent_rc(ptr(cand_v), ptr(cand_i), b, w, ptr(s_t), ptr(safe),
                      t, ptr(out))

        def run_new():
            return tb.rank_count(cand_v, cand_i, s_t, safe)
        run_parent()
        tag = f"B={b} W={w} T={t} k=50{note}"
        equal(f"rank_count {tag}", [run_new()], [out])
        report(f"rank_count {tag}", in_turns(
            {"parent": run_parent, "new": run_new},
            ["parent", "new", "new", "parent"]))

    # ---------------------------------------------------------- submax
    parent_sm = c_fn(libs["parent_topk"], src["parent_topk"], "skrx_submax")
    for tag, (scores, mask, _) in select_cases.items():
        scores, mask = scores.contiguous(), mask.contiguous()
        b, n = scores.shape
        out = torch.empty((b, -(-n // BLOCK_N) * tb.GROUPS), device=dev)

        def run_parent():
            parent_sm(ptr(scores), b, n, BLOCK_N, ptr(mask), mask.shape[1],
                      ptr(out))

        def run_new():
            return tb.submax(scores, mask, BLOCK_N)
        run_parent()
        got = run_new()
        flips = sign_flips(got, out)
        results[f"submax {tag}: signed zeros unlike the parent's"] = flips
        print(f"submax {tag}: (row, group) where a signed zero differs from "
              f"the parent's: {flips}", flush=True)
        if not flips:
            equal(f"submax {tag}", [got], [out])
        equal(f"submax {tag} vs submax_plain", [got],
              [tb.submax_plain(scores, mask, BLOCK_N)])
        report(f"submax {tag}", in_turns(
            {"parent": run_parent, "new": run_new},
            ["parent", "new", "new", "parent"]))

    # ----------------------------------------------- rank_lookup_count
    parent_rl = c_fn(libs["parent_rank"], src["parent_rank"],
                     "skrx_rank_lookup_count")
    for note, cand_v, cand_i, probes in lookup_cases(bpr, u64):
        b, w = cand_v.shape
        t = probes.shape[1]
        out = torch.empty((b, t), device=dev, dtype=torch.int32)
        fnd = torch.empty((b, t), device=dev, dtype=torch.bool)
        segs = rank_segments(cand_v, cand_i).double()
        listed = (cand_v != float("-inf")).sum(1).double()
        print(f"rank_lookup_count B={b}{note}: a row's segments of equal "
              f"keys mean {float(segs.mean())}, max {int(segs.max())}; its "
              f"lanes not -inf mean {float(listed.mean())}, max "
              f"{int(listed.max())}", flush=True)

        def run_parent():
            parent_rl(ptr(cand_v), ptr(cand_i), b, w, ptr(probes), t,
                      ptr(out), ptr(fnd))

        def run_new():
            return tb.rank_lookup_count(cand_v, cand_i, probes)
        run_parent()
        tag = f"B={b} W={w} T={t} k=50{note}"
        if note == ", NaN row":
            plain = tb.rank_lookup_count_plain(cand_v.cpu(), cand_i.cpu(),
                                               probes.cpu())
            equal(f"rank_lookup_count {tag} vs rank_lookup_count_plain",
                  run_new(), [x.to(dev) for x in plain])
            bad = ((out.cpu() != plain[0]) | (fnd.cpu() != plain[1])
                   ).nonzero().tolist()
            results[f"parent vs plain, rank_lookup_count {tag}"] = bad
            print(f"parent rank_lookup_count {tag}: (row, probe) where its "
                  f"rank or found differs from rank_lookup_count_plain: "
                  f"{bad}" + "".join(
                      f"; row {r} probe {q}: parent ({int(out[r, q])}, "
                      f"{bool(fnd[r, q])}), plain ({int(plain[0][r, q])}, "
                      f"{bool(plain[1][r, q])})" for r, q in bad[:4]),
                  flush=True)
            continue
        equal(f"rank_lookup_count {tag}", run_new(), [out, fnd])
        report(f"rank_lookup_count {tag}", in_turns(
            {"parent": run_parent, "new": run_new},
            ["parent", "new", "new", "parent"]))

    # ----------------------------------------------------- direct_rank
    parent_dr = c_fn(libs["parent_rank"], src["parent_rank"],
                     "skrx_direct_rank")
    cases = direct_rank_cases(os.path.join(root, "direct"), dev)
    # ML-1M's batch with NaN scores: every 17th column, and each row's
    # first probe made the id of a NaN column
    _, sc, mask, probes, k = cases[0]
    sc, probes = sc.clone(), probes.clone()
    sc[:, 5::17] = float("nan")
    probes[:, 0] = 5 + 17 * torch.arange(64, device=dev, dtype=torch.int32)
    cases.append((cases[0][0] + ", NaN scores", sc, mask, probes, k))
    for tag, scores, mask, probes, k in cases:
        b, n = scores.shape
        t, width = probes.shape[1], mask.shape[1]
        out = torch.empty((b, t), device=dev, dtype=torch.int32)
        per_row = found_probes(scores, mask, probes).double()

        def run_parent():
            parent_dr(ptr(scores), b, n, ptr(mask), width, ptr(probes), t, k,
                      ptr(out))

        def run_new():
            return tb.direct_rank(scores, probes, k, mask)
        run_parent()
        print(f"direct_rank {tag}: found probes (m_valid) "
              f"{int(per_row.sum())}, a row mean {float(per_row.mean())}, "
              f"max {int(per_row.max())}", flush=True)
        if tag.endswith("NaN scores"):
            plain = tb.direct_rank_plain(scores.cpu(), mask.cpu(),
                                         probes.cpu(), k)
            equal(f"direct_rank {tag} vs direct_rank_plain", [run_new()],
                  [plain.to(dev)])
            bad = (out.cpu() != plain).nonzero().tolist()
            results[f"parent vs plain, direct_rank {tag}"] = len(bad)
            print(f"parent direct_rank {tag}: {len(bad)} (row, probe) pairs "
                  f"differ from direct_rank_plain" + "".join(
                      f"; row {r} probe {q}: parent {int(out[r, q])}, plain "
                      f"{int(plain[r, q])}" for r, q in bad[:4]), flush=True)
            continue
        equal(f"direct_rank {tag}", [run_new()], [out])
        report(f"direct_rank {tag}", in_turns(
            {"parent": run_parent, "new": run_new},
            ["parent", "new", "new", "parent"]))
        events = {name: {"1,000 back-to-back calls": launches_ms(fn, 1000),
                         "one call": time_ms(fn)}
                  for name, fn in (("parent", run_parent), ("new", run_new))}
        results[f"direct_rank {tag}: CUDA events"] = events
        print(f"direct_rank {tag} by CUDA events, ms a call over 1,000 "
              f"back-to-back calls / median of one call: " + ", ".join(
                  f"{name} {e['1,000 back-to-back calls']} / "
                  f"{e['one call']}" for name, e in events.items())
              + f"  [{card}]", flush=True)

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", "chip_ab.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({"ok": True, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
