"""Smoke run of the PyTorch/CUDA port (skrx_torch) on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with a card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; without CUDA it exits 2
before doing anything; run alone, outside a checkout, the import of
skrx_torch fails and it exits 1):

1. Environment: the card's name and power limit (nvidia-smi), the torch
   version, TF32 off for f32 matmuls, and the nvcc build of the kernels
   (every ``csrc/*.cu``, one nvcc each, all started together).
2. Every kernel against its plain PyTorch version on a CPU copy of the same
   inputs. Serving kernels at the serving shape (B=1024 users, the
   40,981-item catalog, k=10, the seen-table width of the generated data);
   the rank kernels at the evaluation shapes (B=64 and 1024, k=50, the
   evaluator's real test-table width T); and adversarial inputs: tie
   storms, fully masked rows, -inf rows, duplicate candidates, signed
   zeros; probes that are masked, out of range, duplicated or scored -inf,
   T=1 and T>128, rows with fewer than k unmasked items; kth_largest at
   W in {128, 256, 1,408, 4,096, 5,000} and k in {1, 10, 50, W} on ties
   across the k-th place, all -inf rows, signed zeros and subnormals,
   negatives only, fewer than k finite entries (its bits equal the plain
   version's); extract at k = 10 and 50 on blocks of 0, 1, 31, 32, 33, k-1,
   k, k+1, F and F+1 survivors (F = 256, the most it ranks directly), a
   block whose every column equals tau and +-0.0 ties (values as int32).
   Selection and counting do no arithmetic, so values, ids and ranks must
   be equal.
3. Serving: Gowalla-scale synthetic data (29,858 users, 40,981 items,
   1,027,370 interactions), BPRMF at its defaults (n_dim=64, random weights
   from a seed) built by name on cuda, TopKRecommender.recommend for
   batches of 1, 16, 64, 256 and 1024 users. The launch counts are reset
   just before and read just after; every serving kernel must have
   launched. Each answer must equal the plain top-k of the same scores on
   the CPU and hold no seen item.
4. Training at Gowalla scale: the same model, fit() for 2 epochs with
   evaluation after each (metrics Precision/Recall/MAP/NDCG at 10..50,
   test batch 64). Both losses finite and falling, rank_count launched
   during fit(), NDCG@10 above the untrained model's, and for 1,024 test
   users the card's per-user metrics equal the plain route's on CPU copies
   of the same scores and tables within 1e-6.
5. Small catalog: synthetic data at MovieLens-1M scale (6,040 users, 3,706
   items, 1,000,209 interactions), fit() for one epoch and its
   evaluate(); direct_rank must have launched, and equals its plain
   version at that shape.
6. LightGCN at Gowalla scale, at its defaults (embed_size 64, 3 layers,
   adj_type "pre", batch 1,024, Adam) on the phase-3 data. The graph
   kernel (segsum, whose last warp to finish a row of several segments
   merges it) against segsum_plain in float64 on CPU copies, per row
   within 1e-5 * sum|msg|, forward (A) and backward (A^T), f32 and bf16
   messages, with and without an edge mask, at the real graph (70,839 rows,
   1,464,964 edges, D=64; its largest in-degree printed) and on adversarial
   graphs: a hub of >= 20 segments, 40 rows of 2-4 segments side by side
   (many merged rows in one block), isolated rows and the empty graph
   (exact zeros), masked edges from inf/NaN rows (finite output), a
   rectangular operator, D=8 and D=128; every arrival counter 0 after each
   launch, and three launches in a row on one graph equal bit for bit. The
   gradient of one batch's loss on the card against the same loss through
   segsum_plain on CPU copies. fit() for 2 epochs with evaluation after
   each: losses finite and falling, NDCG@10 above the untrained model's,
   segsum launched exactly 2 x steps x 6 + 3 per evaluate(). Serving:
   recommend for 1, 64 and 1,024 users equals the plain top-k of the same
   scores and holds no seen item.
7. Fused score-and-select and chunked evaluation. The fused kernels
   (dot_submax, dot_extract) and rank_lookup_count against their plain
   versions on CPU copies, bit for bit (values, ids, tau, ranks, found): at
   the serving shape (B=1024, the Gowalla catalog, d=64, k=10, the seen
   table), at the evaluation shapes (B=64 and 1024, k=50, the evaluator's
   real T and L; B=1 and 7 at the serving shape), and on adversarial
   inputs: duplicated item rows and zero user vectors over a constant bias
   (ties across whole column blocks, more survivors than the list holds),
   item columns repeated every 512 columns (ties across the slices a
   cluster of CTAs splits a block into), fully masked rows and rows with
   fewer than k unmasked items, N not a multiple of the block, d in {8,
   60, 128, 512}, no bias, probes masked, out of range, padding,
   duplicated, one or more than 128 a row; dot_submax alone at B=1, 7 and
   33 (each block split over 8 CTAs) with mask ids in every CTA's slice,
   repeated columns and a zero user vector over a +-0.0 bias, d in {8, 60,
   64, 128, 512} (bits equal, torch.equal of the int32 views).
   TopKRecommender(fused="always") for BPRMF and LightGCN at 1, 64 and
   1,024 users: equal to dot_topk's plain version on CPU copies, no seen
   item, within 1e-5 of the score-matrix route (ids equal where its values
   are separated), and less memory during the call than one (B, N) f32
   score matrix. evaluate() with eval_mode "fused" (BPRMF after phase 4's
   fit(), LightGCN after phase 6's) and "chunked" (BPRMF, 8,192 items a
   chunk): the kernels of each route launched, metrics within 1e-4 of the
   full route's. A catalog of 1,048,576 items (d=64, B=256, random factors
   and seen table from the seed): dot_topk equal to its plain version, and
   the peak memory of both routes.
8. Times on the card: each kernel, its plain version and a library call
   where one computes the same function, as device time per call
   (torch.profiler, 50 calls after warm-up) and as the median time of one
   call between CUDA events (host launch gaps included), and per call of
   200 back-to-back calls between CUDA events; the kernel's bound; the
   selection kernels (submax, kth_largest, extract, dot_submax,
   dot_extract) again at the evaluation shape (B=64, k=50) with their
   bounds (and torch.kthvalue beside kth_largest); vmem_topk at chunked
   evaluate()'s merge (B=64, W=100, k=50, beside torch.topk); direct_rank by the profiler and by CUDA events over 1,000
   back-to-back calls; recommend's p50 per batch size with the
   card's busy share during it (torch.profiler), for the score-matrix and
   the fused route; train steps/s, seconds per epoch and evaluation users/s
   (full, fused and chunked) with the busy share and the top device
   kernels of one epoch and one evaluate(), for BPRMF and LightGCN.

The second-to-last line is the per-kernel JSON record, the last line
``{"ok": true, "device": {...}}``.
"""
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.io import synthetic
from skrx_torch.models.LightGCN import lightgcn_loss
from skrx_torch.models.pipeline import epoch_generator
from skrx_torch.ops import metrics
from skrx_torch.ops.graph import graph_from_coo
from skrx_torch.ops.kernels import _build, runtime
from skrx_torch.ops.kernels import dot_topk as dt
from skrx_torch.ops.kernels import segsum as ss
from skrx_torch.ops.kernels import topk_blocks as tb
from skrx_torch.serve import TopKRecommender

USERS, ITEMS, RATINGS, DIM, K = 29_858, 40_981, 1_027_370, 64, 10
# MovieLens-1M's published counts: the small-catalog route
ML_USERS, ML_ITEMS, ML_RATINGS = 6_040, 3_706, 1_000_209
BATCHES = (1, 16, 64, 256, 1024)
B_KERNEL = 1024
B_EVAL = 64                       # RunConfig.test_batch_size default
K_EVAL = 50                       # max of RunConfig.top_k default
EPOCHS = 2
BLOCK_N = 4096
SEED = 2021
REPS = 50
SERVING = ("submax", "kth_largest", "extract", "pruned_merge")
SOURCE = {name: "skrx_torch/ops/kernels/csrc/topk_blocks.cu"
          for name in SERVING}
SOURCE.update(rank_count="skrx_torch/ops/kernels/csrc/rank_counts.cu",
              rank_lookup_count="skrx_torch/ops/kernels/csrc/rank_counts.cu",
              direct_rank="skrx_torch/ops/kernels/csrc/rank_counts.cu",
              dot_submax="skrx_torch/ops/kernels/csrc/dot_topk.cu",
              dot_extract="skrx_torch/ops/kernels/csrc/dot_topk.cu",
              segsum="skrx_torch/ops/kernels/csrc/segsum.cu")
REPLACES = {"submax": "skrx/ops/pallas/topk_blocks.py:488",
            "kth_largest": "skrx/ops/pallas/topk_blocks.py:224",
            "extract": "skrx/ops/pallas/topk_blocks.py:601",
            "pruned_merge": "skrx/ops/pallas/topk_blocks.py:295",
            "rank_count": "skrx/ops/pallas/topk_blocks.py:815",
            "rank_lookup_count": "skrx/ops/pallas/topk_blocks.py:872",
            "direct_rank": "skrx/ops/pallas/topk_blocks.py:935",
            "dot_submax": "skrx/ops/pallas/dot_topk.py:109",
            "dot_extract": "skrx/ops/pallas/dot_topk.py:115",
            "segsum": "skrx/ops/pallas/segsum_mxu.py:203"}
GCN_SERVE = (1, 64, 1024)
FUSED = ("dot_submax", "dot_extract")
BIG_ITEMS, BIG_B = 1_048_576, 256       # the catalog only fused serves cheaply
CHUNK = 8_192
MSG = {"f32": torch.float32, "bf16": torch.bfloat16}
# F, the most survivors of a block that extract ranks directly
# (csrc/topk_blocks.cu kRankCap)
RANK_CAP = 256
# H100 SXM data sheet: f32 outside the tensor cores, device-memory bytes/s
F32_OPS = 67e12
MEM_RATE = 3.35e12
NEG_INF = float("-inf")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def require(ok: bool, what: str) -> None:
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise AssertionError(what)


def max_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |got - ref| with equal entries (-inf included) counted 0."""
    got, ref = got.cpu().double(), ref.cpu().double()
    diff = torch.where(got == ref, torch.zeros_like(got), (got - ref).abs())
    return float(diff.max()) if diff.numel() else 0.0


def expect_equal(what: str, got, ref, errs: dict, key: str) -> None:
    """Values (and int ids) of the kernel equal the plain version's."""
    for g, r in zip(got, ref):
        g = g.cpu()
        require(g.shape == r.shape and g.dtype == r.dtype,
                f"{what}: {g.shape} {g.dtype} != {r.shape} {r.dtype}")
        # == on floats: -inf equals -inf, -0.0 equals +0.0 (ids decide ties)
        require(bool((g == r).all()), f"{what}: kernel != plain (max abs "
                                      f"err {max_err(g, r)})")
        if g.dtype == torch.float32:
            errs[key] = max(errs.get(key, 0.0), max_err(g, r))


def check_chain(what: str, scores, mask, k: int, errs: dict,
                block_n: int = BLOCK_N):
    """Run the four kernels of blockwise_topk on the card and each plain
    version on CPU copies of the same inputs; returns the card's tensors."""
    s_cpu = scores.cpu()
    m_cpu = None if mask is None else mask.cpu()
    bm = tb.submax(scores, mask, block_n)
    expect_equal(f"{what} submax", [bm],
                 [tb.submax_plain(s_cpu, m_cpu, block_n)], errs, "submax")
    bmf = tb.fold_submaxes(bm, k).contiguous()
    tau = tb.kth_largest(bmf, k)
    tau_ref = tb.kth_largest_plain(bmf.cpu(), k)
    expect_equal(f"{what} kth_largest", [tau], [tau_ref], errs, "kth_largest")
    expect_equal(f"{what} kth_largest bits", [tau.view(torch.int32)],
                 [tau_ref.view(torch.int32)], errs, "kth_largest")
    cv, ci = tb.extract(scores, tau, k, mask, block_n)
    expect_equal(f"{what} extract", [cv, ci],
                 tb.extract_plain(s_cpu, m_cpu, tau.cpu(), k, block_n), errs,
                 "extract")
    mv, mi = tb.pruned_merge(cv, ci, k, tau)
    expect_equal(f"{what} pruned_merge", [mv, mi],
                 tb.pruned_merge_plain(cv.cpu(), ci.cpu(), k, tau.cpu()), errs,
                 "pruned_merge")
    vv, vi = tb.vmem_topk(cv, ci, k)
    expect_equal(f"{what} vmem_topk", [vv, vi],
                 tb.pruned_merge_plain(cv.cpu(), ci.cpu(), k,
                                       torch.full_like(tau.cpu(), NEG_INF)),
                 errs, "pruned_merge")
    require(torch.equal(vv.cpu(), mv.cpu())
            and torch.equal(vi.cpu(), mi.cpu()),
            f"{what}: vmem_topk != pruned_merge")
    return bmf, tau, cv, ci


def adversarial(dev, errs: dict) -> None:
    rng = np.random.default_rng(SEED)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    # tie storm: constant rows with one high column, lightly masked
    s = np.zeros((64, ITEMS), np.float32)
    s[:, 700] = 2.0
    s[1:8] = np.round(rng.standard_normal((7, ITEMS)))       # many ties
    mask = np.full((64, 8), ITEMS, np.int32)
    mask[:, 0] = 0
    check_chain("tie storm", t(s), t(mask), K, errs)
    # fully masked rows, rows with < k unmasked or finite items, -inf rows
    n = 8192
    s = rng.standard_normal((8, n)).astype(np.float32)
    mask = np.full((8, n), n, np.int32)
    mask[0] = np.arange(n)
    mask[1, :n - 4] = rng.permutation(n)[:n - 4]
    s[2] = NEG_INF
    s[3, 5:] = NEG_INF
    mask[4, :5] = [-1, n + 3, 7, 7, n - 1]
    check_chain("masked/-inf rows", t(s), t(mask), K, errs)
    check_chain("masked/-inf rows k=50", t(s), t(mask), 50, errs)
    # duplicate (value, id) candidates and value ties for the merge
    w = 300
    vals = np.round(rng.standard_normal((64, w)) * 2).astype(np.float32)
    ids = np.stack([rng.permutation(w) for _ in range(64)]).astype(np.int32)
    vals[:, :6], ids[:, :6] = vals[:, 6:7], ids[:, 6:7]
    vals[5, 10:] = NEG_INF
    tau = torch.full((64,), NEG_INF)
    got = tb.pruned_merge(t(vals), t(ids), K, tau.to(dev))
    expect_equal("duplicate candidates", got,
                 tb.pruned_merge_plain(t(vals).cpu(), t(ids).cpu(), K, tau),
                 errs, "pruned_merge")
    kth_adversarial(dev, errs)
    extract_adversarial(dev, errs)


def kth_rows(rng, w: int) -> np.ndarray:
    """(11, w) f32 rows built to break a selection of the k-th largest (k
    in {1, 10, 50, W}): ties across the k-th place, all -inf, negatives
    only, signed zeros and subnormals, 5 finite entries, +inf, one value.
    The tests of kth_largest use them too."""
    x = rng.standard_normal((11, w)).astype(np.float32)
    x[1] = np.round(x[1] * 2)
    x[2, rng.choice(w, min(w, 60), replace=False)] = 3.0   # places 1..60 tie
    x[3] = NEG_INF
    x[4] = -np.abs(x[4]) - 1.0
    x[5] = np.where(rng.random(w) < 0.5, -0.0, 0.0)
    x[5, :4] = [1e-40, -1e-40, 1e-45, -1e-45]
    x[6] = -0.0
    x[6, :20] = 0.0
    x[7, 5:] = NEG_INF
    x[8] = rng.standard_normal(w) * 1e-39                  # subnormals only
    x[9, :3] = np.inf
    x[10] = 0.25
    return x


def kth_adversarial(dev, errs: dict) -> None:
    """kth_largest at every instantiation's width and past the widest
    (5,000 reads the row each round), k in {1, 10, 50, W}: bits equal to
    the plain version's (torch.equal of the int32 views)."""
    rng = np.random.default_rng(SEED + 5)
    for w in (128, 256, 1408, 4096, 5000):
        x = torch.from_numpy(kth_rows(rng, w))
        xd = x.to(dev)
        for k in sorted({1, min(10, w), min(50, w), w}):
            got = tb.kth_largest(xd, k).cpu()
            ref = tb.kth_largest_plain(x, k)
            require(torch.equal(got.view(torch.int32), ref.view(torch.int32)),
                    f"kth_largest W={w} k={k}: kernel != plain")
            errs["kth_largest"] = max(errs.get("kth_largest", 0.0),
                                      max_err(got, ref))


def extract_rows(rng, k: int, block_n: int = BLOCK_N):
    """(scores (R, N), mask table (R, 8), tau (R,), founds): rows built to
    break extract's selection, N = 2 block_n + 100 (a ragged third block).
    Block 0 of row r < len(founds) holds exactly founds[r] survivors (at
    or above tau = 1.0, ties among them, three more masked away): 0, 1, 31,
    32, 33 (one warp and past it), k - 1, k, k + 1, and F, F + 1 (the most
    extract ranks directly, csrc/topk_blocks.cu kRankCap); its other blocks
    a few survivors and -inf columns. Then a row whose block 1 is tau in
    every column, and one of +0.0 and -0.0 ties at tau = +0.0 (300 in block
    0, past F; 40 in block 1). The tests of extract use them too."""
    founds = sorted({0, 1, 31, 32, 33, k - 1, k, k + 1, RANK_CAP,
                     RANK_CAP + 1})
    n = 2 * block_n + 100
    rows = len(founds) + 2
    s = rng.uniform(-3.0, 0.99, (rows, n)).astype(np.float32)
    tau = np.ones(rows, np.float32)
    mask = np.full((rows, 8), n, np.int32)
    mask[:, 5:] = [-1, n + 7, 2 * block_n + 3]   # padding, out of range, real
    for r, f in enumerate(founds):
        cols = rng.choice(block_n, f + 3, replace=False)
        s[r, cols] = 1.0 + np.round(rng.random(f + 3) * 4) / 4
        mask[r, :3] = cols[:3]
        later = block_n + rng.choice(n - block_n, 60, replace=False)
        s[r, later[:40]] = NEG_INF
        s[r, later[40:]] = 1.5
    r = len(founds)
    s[r, block_n:2 * block_n] = tau[r]
    r += 1
    tau[r] = 0.0
    s[r] = -1.0
    s[r, :300] = np.where(rng.random(300) < 0.5, -0.0, 0.0)
    s[r, block_n:block_n + 40] = np.where(rng.random(40) < 0.5, -0.0, 0.0)
    return s, mask, tau, founds


def extract_adversarial(dev, errs: dict) -> None:
    """extract on extract_rows at k = 10 and 50: values (as int32, so signed
    zeros count) and ids equal to extract_plain's."""
    rng = np.random.default_rng(SEED + 6)
    for k in (K, K_EVAL):
        s, mask, tau, founds = extract_rows(rng, k)
        s_t, m_t, tau_t = (torch.from_numpy(x) for x in (s, mask, tau))
        found = ((tb._masked_padded(s_t, m_t, BLOCK_N)[:, :BLOCK_N]
                  >= tau_t[:, None]).sum(1))
        require(found[:len(founds)].tolist() == founds,
                f"extract rows: block 0 holds {found.tolist()} survivors")
        got = tb.extract(s_t.to(dev), tau_t.to(dev), k, m_t.to(dev), BLOCK_N)
        ref = tb.extract_plain(s_t, m_t, tau_t, k, BLOCK_N)
        require(torch.equal(got[0].cpu().view(torch.int32),
                            ref[0].view(torch.int32))
                and torch.equal(got[1].cpu(), ref[1]),
                f"extract k={k}, survivors {founds}: kernel != plain")
        errs["extract"] = max(errs.get("extract", 0.0),
                              max_err(got[0], ref[0]))


def rank_case(rng, n: int, b: int, width: int, t_count: int, k: int):
    """Scores, mask table and probes for the rank kernels: a tie storm, a
    row of ties, a row with fewer than k finite items, one with fewer than
    k unmasked items (when the table is as wide as the catalog); probes
    that are masked, out of range, duplicated or scored -inf, and probes
    from the row's masked top-2k so that ranks below k occur."""
    s = rng.standard_normal((b, n)).astype(np.float32)
    s[0] = 0.0
    s[1] = np.round(s[1])
    s[2, k // 2:] = NEG_INF
    mask = rng.integers(0, n, (b, width)).astype(np.int32)
    mask[:, -4:] = n                                   # padding
    if width >= n:
        mask[3] = np.arange(width) % n                 # row 3 fully masked
        mask[3, : k // 2] = n
    probes = rng.integers(-3, n + 3, (b, max(t_count, 64))).astype(np.int32)
    masked = metrics.mask_items(torch.from_numpy(s), torch.from_numpy(mask))
    probes[:, :20] = torch.sort(masked, dim=1, descending=True,
                                stable=True).indices[:, :20].numpy()
    probes[:, 20:25] = mask[:, :5]                     # masked
    probes[:, 25:30] = probes[:, 30:31]                # duplicated
    probes[2, 30:35] = np.arange(k, k + 5)             # scored -inf
    return s, mask, probes[:, :t_count]


def check_ranks(what: str, scores, mask, probes, k: int,
                errs: dict) -> torch.Tensor:
    """direct_rank and, where the catalog takes the candidate route,
    rank_count and masked_topk_ranks, on the card against their plain
    versions on CPU copies; below k the two routes agree. Returns the
    plain ranks."""
    s_cpu, p_cpu = scores.cpu(), probes.cpu()
    m_cpu = None if mask is None else mask.cpu()
    ref = tb.direct_rank_plain(s_cpu, m_cpu, p_cpu, k)
    expect_equal(f"{what} direct_rank", [tb.direct_rank(scores, probes, k,
                                                        mask)],
                 [ref], errs, "direct_rank")
    if not metrics.use_blockwise_ranks(scores.shape[1], k):
        return ref
    cv, ci, _ = tb.blockwise_candidates(scores, k, BLOCK_N, mask)
    st = scores.gather(1, probes.clamp(0, scores.shape[1] - 1).long())
    expect_equal(f"{what} rank_count", [tb.rank_count(cv, ci, st, probes)],
                 [tb.rank_count_plain(cv.cpu(), ci.cpu(), st.cpu(), p_cpu)],
                 errs, "rank_count")
    ranks = tb.masked_topk_ranks(scores, k, probes, mask)
    expect_equal(f"{what} masked_topk_ranks", [ranks],
                 [tb.masked_topk_ranks(s_cpu, k, p_cpu, m_cpu)], errs,
                 "rank_count")
    require(torch.equal(ranks.cpu().clamp(max=k), ref.clamp(max=k)),
            f"{what}: the two rank routes disagree below k")
    return ref


def adversarial_ranks(dev, errs: dict) -> None:
    rng = np.random.default_rng(SEED + 2)
    for n, width in ((ITEMS, 300), (ML_ITEMS, ML_ITEMS)):
        s, mask, probes = rank_case(rng, n, 16, width, 424, K_EVAL)
        for t_count in (1, 130, 424):
            ref = check_ranks(f"adversarial N={n} T={t_count}",
                              *(torch.from_numpy(x).to(dev)
                                for x in (s, mask, probes[:, :t_count])),
                              K_EVAL, errs)
            require(int((ref < K_EVAL).sum()) > 0
                    and (t_count == 1 or int((ref == K_EVAL).sum()) > 0),
                    f"N={n} T={t_count}: hits and misses both occur")
        check_ranks(f"adversarial N={n} no mask",
                    torch.from_numpy(s).to(dev), None,
                    torch.from_numpy(probes).to(dev), K_EVAL, errs)


def check_segsum(seg, x, mask, msg: str, errs: dict):
    """segsum (its merge pass included) on the card against segsum_plain in
    float64 on CPU copies: per row |kernel - ref| <= 1e-5 * sum|msg| +
    1e-30, rows without a kept edge exactly 0, the output finite, every
    arrival counter back at 0. Returns the kernel's and the f32 plain
    version's largest error as a share of the bound."""
    seg_cpu = seg.to("cpu")
    x_cpu = x.cpu()
    m_cpu = None if mask is None else mask.cpu()
    dtype = MSG[msg]
    got = ss.segsum(seg, x, mask, dtype).cpu().double()
    ref = ss.segsum_plain(seg_cpu, x_cpu.double(), m_cpu, dtype)
    scale = ss.segsum_plain(seg_cpu._replace(weight=seg_cpu.weight.abs()),
                            x_cpu.abs().double(), m_cpu, dtype)
    bound = 1e-5 * scale + 1e-30
    err = (got - ref).abs()
    plain = (ss.segsum_plain(seg_cpu, x_cpu, m_cpu, dtype).double()
             - ref).abs()
    require(bool(torch.isfinite(got).all()), "segsum: non-finite output")
    require(bool((err <= bound).all()),
            f"segsum {msg}: error {float((err / bound).max())} x the bound")
    require(bool((got[scale == 0] == 0).all()),
            "segsum: a row without a kept edge is not 0")
    require(not bool(seg.merge_count.any()), "segsum left a counter set")
    if not err.numel():
        return 0.0, 0.0
    errs["segsum"] = max(errs.get("segsum", 0.0), float(err.max()))
    return float((err / bound).max()), float((plain / bound).max())


def check_repeat(seg, x, mask, msg: str, calls: int = 3) -> None:
    """``calls`` launches in a row on one Segments: each output's bits equal
    the first's, and the arrival counters are 0 after each (the merge pass
    resets them)."""
    first = ss.segsum(seg, x, mask, MSG[msg])
    for i in range(1, calls):
        again = ss.segsum(seg, x, mask, MSG[msg])
        torch.cuda.synchronize()
        require(torch.equal(again.view(torch.int32), first.view(torch.int32))
                and not bool(seg.merge_count.any()),
                f"segsum {msg}: launch {i + 1} on one Segments differs")


def segsum_adversarial(dev, errs: dict) -> None:
    """The kernel on graphs built to break it, D = 8, 64 and 128, both
    message types, with and without an edge mask."""
    rng = np.random.default_rng(SEED + 3)
    hub = 20 * ss.SEGMENT_EDGES + 3
    # 40 rows of 2 to 4 segments side by side: many merged rows in a block
    multi = np.repeat(np.arange(40), rng.integers(129, 4 * 128 + 1, 40))
    cases = {
        # one destination of >= 20 segments
        "hub": (rng.integers(0, 900, hub), np.zeros(hub, np.int64),
                rng.random(hub), 40, 900),
        "merged rows in one block": (rng.integers(0, 900, len(multi)), multi,
                                     rng.random(len(multi)), 60, 900),
        # 380 of 400 rows without edges
        "isolated rows": (rng.integers(0, 400, 300),
                          rng.integers(0, 20, 300) * 19, rng.random(300),
                          400, 400),
        "empty graph": (np.array([], np.int64), np.array([], np.int64),
                        np.array([]), 33, 33),
        "rectangular": (rng.integers(0, 5000, 40_000),
                        rng.integers(0, 1500, 40_000), rng.random(40_000),
                        1500, 5000),
        "inf/NaN sources": (rng.integers(0, 600, 9000),
                            rng.integers(0, 600, 9000), rng.random(9000),
                            600, 600),
    }
    for name, (src, dst, w, n, n_src) in cases.items():
        g = graph_from_coo(src, dst, w, n, num_src_nodes=n_src, device=dev)
        mask = torch.from_numpy((rng.random(len(src)) < 0.35)
                                .astype(np.float32) / 0.35).to(dev)
        shares = []
        for d in (8, 64, 128):
            x = torch.randn((n_src, d), device=dev)
            masks = (None, mask)
            if name == "inf/NaN sources":   # their edges all dropped
                bad = torch.tensor([5, 99, 300], device=dev)
                x[bad, 0::2] = float("inf")
                x[bad, 1::2] = float("nan")
                mask[g.fwd.orig[torch.isin(g.fwd.src, bad.int())].long()] = 0
                masks = (mask,)
            for msg in MSG:
                for m in masks:
                    shares.append(check_segsum(g.fwd, x, m, msg, errs))
                    check_repeat(g.fwd, x, m, msg)
                    if name == "rectangular":
                        shares.append(check_segsum(
                            g.bwd, torch.randn((n, d), device=dev), m, msg,
                            errs))
        print(f"  segsum {name} ({len(src)} edges, largest in-degree "
              f"{g.fwd.max_degree}): worst error {max(a for a, _ in shares)}"
              f" of the bound, f32 plain {max(b for _, b in shares)}",
              flush=True)


def check_served(server, u, ids, vals, seen) -> torch.Tensor:
    """A served answer equals the plain top-k of the model's scores for
    the same users (blockwise_topk and a full sort on CPU copies) and holds
    no seen item; returns the scores' CPU copy."""
    require(ids.shape == vals.shape == (len(u), K)
            and np.isfinite(vals).all(), "finite (B, k) answers")
    s_cpu = server.model.predict(u).cpu()
    m_cpu = server._seen[torch.as_tensor(u, device=server.device)].cpu()
    ref_v, ref_i = tb.blockwise_topk(s_cpu, K, mask_table=m_cpu)
    np.testing.assert_array_equal(ids, ref_i.numpy())
    np.testing.assert_array_equal(vals, ref_v.numpy())
    _, sort_i = metrics.topk_scores_and_indices(s_cpu, K, m_cpu)
    np.testing.assert_array_equal(ids, sort_i.numpy())
    for user, row in zip(u, ids):
        require(not np.isin(row, seen.get(int(user), [])).any(),
                f"user {user} got a seen item")
    return s_cpu


def cpu_packed(packed: dt.PackedItems) -> dt.PackedItems:
    return packed._replace(table=packed.table.cpu(), bias=packed.bias.cpu())


def check_fused(what: str, uv, packed, mask, k: int, errs: dict):
    """dot_submax and dot_extract on the card against their plain versions
    on CPU copies of the same inputs, bit for bit; tau as the composition
    takes it. Returns the card's (tau, cand_vals, cand_ids)."""
    pc, uv_c = cpu_packed(packed), uv.cpu()
    m_c = None if mask is None else mask.cpu()
    scores = dt.dot_scores_plain(uv_c, pc)   # what both plain versions score
    bm = dt.dot_submax(uv, packed, mask)
    expect_equal(f"{what} dot_submax", [bm],
                 [tb.submax_plain(scores, m_c, pc.block_n)], errs,
                 "dot_submax")
    if bm.shape[1] >= k:
        bmf = tb.fold_submaxes(bm, k).contiguous()
        tau = tb.kth_largest(bmf, k)
        expect_equal(f"{what} tau bits", [tau.view(torch.int32)],
                     [tb.kth_largest_plain(bmf.cpu(), k).view(torch.int32)],
                     errs, "kth_largest")
    else:
        tau = torch.full((uv.shape[0],), NEG_INF, device=uv.device)
    cv, ci = dt.dot_extract(uv, packed, tau, k, mask)
    expect_equal(f"{what} dot_extract", [cv, ci],
                 tb.extract_plain(scores, m_c, tau.cpu(), k, pc.block_n),
                 errs, "dot_extract")
    return tau, cv, ci


def check_lookup(what: str, cv, ci, probes, errs: dict) -> None:
    """rank_lookup_count on the card against its plain version on CPU
    copies: ranks and found equal."""
    expect_equal(f"{what} rank_lookup_count",
                 tb.rank_lookup_count(cv, ci, probes),
                 tb.rank_lookup_count_plain(cv.cpu(), ci.cpu(), probes.cpu()),
                 errs, "rank_lookup_count")


def lookup_probes(rng, ids, mask, n: int, t_count: int) -> np.ndarray:
    """Probes for rank_lookup_count: the row's candidate ids (found, some
    of rank < k), masked ids, padding (n), out of range, duplicated and
    random ids."""
    p = rng.integers(-3, n + 3, (ids.shape[0], max(t_count, 40)))
    p[:, :12] = ids[:, :12]
    if mask is not None:
        p[:, 12:17] = mask[:, :5]                      # masked
    p[:, 17], p[:, 18], p[:, 19] = n, -1, n + 5        # padding, out of range
    p[:, 20:26] = p[:, 1:2]                            # duplicated
    return p[:, :t_count].astype(np.int32)


def fused_adversarial(dev, items, errs: dict) -> None:
    """The fused kernels on inputs built to break them."""
    rng = np.random.default_rng(SEED + 4)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    # duplicated item rows, and zero user vectors over a constant bias:
    # every score of a row equal, across whole 4,096-column blocks
    dup = items.clone()
    dup[ITEMS // 2: ITEMS // 2 + 4096] = dup[:4096]
    uv = torch.randn((64, DIM), device=dev,
                     generator=torch.Generator(dev).manual_seed(SEED))
    uv[::2] = 0.0
    mask = rng.integers(0, ITEMS, (64, 40)).astype(np.int32)
    mask[:, -5:] = ITEMS
    for bias in (torch.full((ITEMS,), 0.5, device=dev), None):
        packed = dt.pack_items(dup, bias)
        for k in (K, K_EVAL):
            _, cv, ci = check_fused(f"tie storm k={k}", uv, packed, t(mask), k,
                                    errs)
            check_lookup(f"tie storm k={k}", cv, ci, t(lookup_probes(
                rng, ci.cpu().numpy(), mask, ITEMS, 300)), errs)
    # ties across the slices that a cluster splits a column block into: at
    # B=64 eight CTAs score 512 columns each, and each column c of a block
    # repeats at c + 512, c + 1024, ... so that every score of a row ties
    # with one in each other slice; found stays under the list's cap
    tied = items.clone()
    for blk in range(0, ITEMS - BLOCK_N, BLOCK_N):
        tied[blk + 512: blk + BLOCK_N] = tied[blk: blk + 512].repeat(7, 1)
    packed = dt.pack_items(tied, torch.full((ITEMS,), 0.25, device=dev))
    uv = torch.randn((64, DIM), device=dev,
                     generator=torch.Generator(dev).manual_seed(SEED + 1))
    for k in (K, K_EVAL):
        _, cv, ci = check_fused(f"slice ties k={k}", uv, packed, t(mask), k,
                                errs)
        require(bool((cv[:, 1] == cv[:, 0]).all()),
                "slice ties: the two best of a block tie")
    # fully masked rows and rows with fewer than k unmasked items, N not a
    # multiple of the block
    n = 8192 + 1000
    packed = dt.pack_items(torch.randn((n, DIM), device=dev), None)
    uv = torch.randn((8, DIM), device=dev)
    mask = np.full((8, n), n, np.int32)
    mask[0] = np.arange(n)
    mask[1, : n - 4] = rng.permutation(n)[: n - 4]
    mask[2, :5] = [-1, n + 3, 7, 7, n - 1]
    for k in (K, K_EVAL):
        _, cv, ci = check_fused(f"masked rows k={k}", uv, packed, t(mask), k,
                                errs)
        for t_count in (1, 130):
            check_lookup(f"masked rows k={k} T={t_count}", cv, ci,
                         t(lookup_probes(rng, ci.cpu().numpy(), mask, n,
                                         t_count)), errs)
    # other widths, with and without a bias; a small catalog (n_sub < k:
    # tau = -inf)
    for d, n, bias in ((8, 5000, True), (60, 9000, False), (128, 4100, True),
                       (512, 6000, False), (16, 300, True)):
        b = 33
        items_d = torch.randn((n, d), device=dev)
        packed = dt.pack_items(items_d, torch.randn(n, device=dev)
                               if bias else None)
        uv = torch.randn((b, d), device=dev)
        mask = rng.integers(-2, n + 2, (b, 50)).astype(np.int32)
        k = 200 if n == 300 else K_EVAL
        _, cv, ci = check_fused(f"d={d} N={n}", uv, packed, t(mask), k, errs)
        check_lookup(f"d={d} N={n}", cv, ci, t(lookup_probes(
            rng, ci.cpu().numpy(), mask, n, 300)), errs)
    submax_adversarial(dev, items, errs)
    try:
        dt.pack_items(torch.zeros((10, dt.MAX_DIM + 1), device=dev))
    except ValueError:
        pass
    else:
        raise AssertionError("d > 512 must be refused")


def submax_adversarial(dev, items, errs: dict) -> None:
    """dot_submax where a 4,096-column block is split over a cluster of 8
    CTAs (B = 1, 7 and 33 over the Gowalla catalog), bit for bit against
    its plain version on CPU copies (torch.equal of the int32 views): item
    columns repeated every 512 (equal group maxima in every CTA's slice),
    mask ids in every slice of every block, a fully masked row, a zero user
    vector over a bias of +-0.0 (zero maxima are +0.0); then d in {8, 60,
    128, 512} on smaller catalogs, N not a multiple of the block."""
    rng = np.random.default_rng(SEED + 6)
    tied = items.clone()
    for blk in range(0, ITEMS - BLOCK_N, BLOCK_N):
        tied[blk + 512: blk + BLOCK_N] = tied[blk: blk + 512].repeat(7, 1)
    zeros = torch.from_numpy(np.where(rng.random(ITEMS) < 0.5, -0.0, 0.0)
                             .astype(np.float32)).to(dev)
    cases = [(dt.pack_items(tied, zeros), DIM)]
    for d, n in ((8, 9000), (60, 9000), (128, 5000), (512, 6000)):
        cases.append((dt.pack_items(torch.randn((n, d), device=dev),
                                    torch.randn(n, device=dev)), d))
    for packed, d in cases:
        pc, n = cpu_packed(packed), packed.n
        n_sl = n // 512
        table = np.full((33, n), n, np.int32)
        for r in range(33):                   # 5 ids in each 512-column slice
            table[r, :5 * n_sl] = (np.arange(n_sl).repeat(5) * 512
                                   + rng.integers(0, 512, 5 * n_sl))
        table[1] = np.arange(n)               # fully masked
        for b in (1, 7, 33):
            uv = torch.randn((b, d), device=dev)
            uv[2:3] = 0.0                     # scores = bias
            for m in (torch.from_numpy(table[:b]).to(dev), None):
                got = dt.dot_submax(uv, packed, m).cpu()
                ref = tb.submax_plain(dt.dot_scores_plain(uv.cpu(), pc),
                                      None if m is None else m.cpu(),
                                      pc.block_n)
                require(torch.equal(got.view(torch.int32),
                                    ref.view(torch.int32)),
                        f"dot_submax B={b} d={d} N={n}: kernel != plain")
                errs["dot_submax"] = max(errs.get("dot_submax", 0.0),
                                         max_err(got, ref))


def peak_above(fn):
    """(result, peak device bytes allocated during fn() above what was
    allocated before it)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def serve_measured(server, u):
    """(u, ids, scores, peak bytes) of server.recommend(u), called once
    before so that the packed item table is cached."""
    server.recommend(u)
    (ids, vals), peak = peak_above(lambda: server.recommend(u))
    return u, ids, vals, peak


def check_fused_served(server, u, ids, vals, peak, seen) -> int:
    """A fused answer equals dot_topk's plain version on CPU copies, holds
    no seen item, and is within 1e-5 (relative) of the score-matrix route,
    with ids equal where that route's values are separated by more; the
    call allocated less than one (B, N) f32 score matrix above what was
    allocated before it. Returns the rows whose ids differ from the
    score-matrix route."""
    require(peak < 4 * len(u) * ITEMS,
            f"fused recommend B={len(u)} allocated {peak} B")
    u_all, _ = server.model._chunk_embeddings()
    u_t = torch.as_tensor(u, device=server.device)
    ref_v, ref_i = dt.dot_topk_plain(
        u_all.detach()[u_t].cpu(), cpu_packed(server._packed_cache[2]), K,
        server._seen[u_t].cpu())
    np.testing.assert_array_equal(ids, ref_i.numpy())
    np.testing.assert_array_equal(vals, ref_v.numpy())
    for user, row in zip(u, ids):
        require(not np.isin(row, seen.get(int(user), [])).any(),
                f"user {user} got a seen item (fused)")
    # the score-matrix route's top k + 1, so that the last slot's gap to
    # the next item is known
    m_vals, m_ids = metrics.topk_scores_and_indices(
        server.model.predict(u_t), K + 1, mask_table=server._seen[u_t])
    m_vals, m_ids = m_vals.cpu().numpy(), m_ids.cpu().numpy()
    np.testing.assert_allclose(vals, m_vals[:, :K], rtol=1e-5, atol=1e-6)
    gap = np.abs(np.diff(m_vals, axis=1)) > 1e-5 * np.abs(m_vals[:, 1:])
    sep = gap[:, :K].copy()
    sep[:, 1:] &= gap[:, :K - 1]
    m_ids = m_ids[:, :K]
    require(sep.mean() > 0.9, f"separated slots {sep.mean()}")
    np.testing.assert_array_equal(ids[sep], m_ids[sep])
    print(f"  fused recommend B={len(u)}: == plain, {peak} B above the "
          f"allocated (one score matrix {4 * len(u) * ITEMS} B), "
          f"{int((ids != m_ids).any(1).sum())} rows with ids unlike the "
          f"score-matrix route", flush=True)
    return int((ids != m_ids).any(1).sum())


def select_ops(found: torch.Tensor, k: int) -> int:
    """Operations of extract's selection for these survivor counts per
    (row, block): found^2 compares where it ranks (found <= RANK_CAP), k
    rounds over the block's survivors where it does not."""
    found = found.long()
    rank = found <= RANK_CAP
    return int((found * found)[rank].sum()
               + (found.clamp(max=k) * found)[~rank].sum())


def evaluate_as(m, mode: str, chunk_size: int = 0):
    """(MetricReport, host seconds) of m.evaluate() with the evaluator's
    eval_mode (and chunk size) set for the call."""
    ev = m.evaluator
    saved = ev.eval_mode, ev.chunk_size
    ev.eval_mode, ev.chunk_size = mode, chunk_size or ev.chunk_size
    try:
        return timed(m.evaluate)
    finally:
        ev.eval_mode, ev.chunk_size = saved


def time_ms(fn, reps: int = REPS) -> float:
    """Median device time of fn() over reps launches (CUDA events)."""
    for _ in range(5):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def launches_ms(fn, reps: int = 200) -> float:
    """Time per call of reps back-to-back calls of fn between two CUDA
    events (after warm-up): device time where the card is the bottleneck,
    the host's launch rate where the kernel is shorter than a launch."""
    for _ in range(5):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_events(prof):
    """Kernel and copy events of a profile, user annotations left out (an
    optimizer's step range shows up as a device row)."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and "#" not in e.key]


def device_ms(fn, reps: int = REPS) -> float:
    """Device time per call of fn: the summed durations of the kernels and
    copies it launches (torch.profiler), over reps calls after warm-up.
    Unlike time_ms it
    leaves out the idle gaps while the host launches, which dominate a
    kernel of a few microseconds. A profile now and then records no device
    event at all; it is taken again, and after three empty ones the
    CUDA-event time of time_ms stands in (a line says so)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in _device_events(prof))
        if total_us > 0:
            return total_us / reps / 1e3
    print("device_ms: three profiles recorded no device time; CUDA-event "
          "time instead", flush=True)
    return time_ms(fn, reps)


def busy_share(fn, reps: int = 20, warm: bool = True, top: int = 0):
    """Share of the host-clock time of ``reps`` calls of fn in which the
    card ran a kernel or a copy (sum of device event times from
    torch.profiler over the wall time; the profiler slows the host, so this
    is a lower bound), and the ``top`` device kernels by time as (name,
    ms, calls). The share is None when the profiler records no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = sorted(_device_events(prof),
                    key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in events)
    heads = [(e.key[:60], e.self_device_time_total / 1e3, e.count)
             for e in events[:top]]
    return (busy_us / wall_us if busy_us > 0 else None), heads


def timed(fn):
    """(result, host seconds) of fn() ended by a device sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def counted(fn):
    """(result, launches per kernel) of fn(): the counts are set to 0 just
    before and read just after."""
    torch.cuda.synchronize()
    runtime.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(runtime.LAUNCHES)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")
    require(not torch.backends.cuda.matmul.allow_tf32
            and torch.get_float32_matmul_precision() == "highest",
            "f32 matmuls must run without TF32")
    t0 = time.perf_counter()
    _build.load("segsum")
    info = _build.build_info()
    print(f"kernels ready in {time.perf_counter() - t0:.2f} s (nvcc "
          f"{info.get('seconds', 0.0):.2f} s, built {info.get('built')})")
    for stem, log in info.get("log", {}).items():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"  ptxas {stem}: {line.strip()}")

    # ---------------------------------------------------------------- data
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_data")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    path = synthetic.make_dataset_dir(root, num_users=USERS, num_items=ITEMS,
                                      num_ratings=RATINGS, seed=SEED)
    reg = ModelRegistry()
    reg.load_skrx_model("BPRMF")
    model_cls, _ = reg.get_model("BPRMF")
    model = model_cls(RunConfig(recommender="BPRMF", data_dir=path,
                                seed=SEED),
                      {"n_dim": DIM, "epochs": EPOCHS, "early_stop": EPOCHS})
    require((model.num_users, model.num_items, model.dataset.num_ratings)
            == (USERS, ITEMS, RATINGS), "catalog size")
    require(model.user_emb.device == dev
            and model.item_emb.shape == (ITEMS, DIM), "model on the card")
    server = TopKRecommender(model, k=K)
    seen_w = server._seen.shape[1]
    ev = model.evaluator
    test_users = np.fromiter(ev.user_pos_test, np.int64)
    print(f"data + model ready in {time.perf_counter() - t0:.1f} s: "
          f"{USERS} users, {ITEMS} items, {RATINGS} interactions, "
          f"seen-table width {seen_w}, {len(test_users)} test users",
          flush=True)

    # ------------------------------------------- phase 2: kernels vs plain
    rng = np.random.default_rng(SEED + 1)
    errs: dict = {}
    users = torch.as_tensor(rng.integers(0, USERS, B_KERNEL), device=dev)
    scores = model.predict(users)
    mask = server._seen[users]
    bmf, tau, cv, ci = check_chain("slice shape", scores, mask, K, errs)
    adversarial(dev, errs)
    eval_in = {}
    for bsz in (B_EVAL, B_KERNEL):
        u = rng.choice(test_users, bsz, replace=False)
        tr, te, tl = ev._tables_for(u, ITEMS)
        eval_in[bsz] = (u, model.predict(u), torch.from_numpy(tr).to(dev),
                        torch.from_numpy(te).to(dev),
                        torch.from_numpy(np.maximum(tl, 1)).to(dev))
        check_ranks(f"evaluation shape B={bsz}", *eval_in[bsz][1:4], K_EVAL,
                    errs)
    t_eval, l_eval = eval_in[B_EVAL][3].shape[1], eval_in[B_EVAL][2].shape[1]
    adversarial_ranks(dev, errs)
    print(f"kernels == plain versions (max abs err {errs}); evaluation "
          f"tables: train width {l_eval}, test width T={t_eval}", flush=True)

    # ---------------------------------------------------- phase 3: serving
    served = []

    def serve_all():
        for bs in BATCHES:
            u = rng.integers(0, USERS, bs)
            served.append((u,) + server.recommend(u))
    _, serve_launches = counted(serve_all)
    print(f"launches while serving {len(BATCHES)} requests: "
          f"{serve_launches}")
    for kname in SERVING:
        require(serve_launches[kname] >= 1,
                f"{kname} never launched while serving")
    seen = model.dataset.train_data.to_user_dict()
    for u, ids, vals in served:
        s_cpu = check_served(server, u, ids, vals, seen)
        # predict against float64 on the CPU: |err| <= 1e-6 + 1e-5 |ref|
        u_t = torch.as_tensor(u, device=dev)
        ue = model.user_emb.detach()[u_t].cpu().double()
        ref = ue @ model.item_emb.detach().cpu().double().T \
            + model.item_bias.detach().cpu().double()
        np.testing.assert_allclose(s_cpu.double().numpy(), ref.numpy(),
                                   rtol=1e-5, atol=1e-6)
    print("recommend == plain top-k of the same scores, no seen item, "
          "predict within 1e-6 + 1e-5|ref| of float64", flush=True)

    # ---------------------------------------- phase 4: training at Gowalla
    ndcg0 = model.evaluate()["NDCG@10"]
    best, fit_launches = counted(model.fit)
    losses = [h["loss"] for h in model.history]
    print(f"launches during fit() ({EPOCHS} epochs + {EPOCHS} evaluations):"
          f" {fit_launches}")
    require(len(losses) == EPOCHS and bool(np.isfinite(losses).all())
            and losses[1] < losses[0], f"losses finite and falling: {losses}")
    for kname in ("submax", "kth_largest", "extract", "rank_count"):
        require(fit_launches[kname] >= 1, f"{kname} never launched in fit()")
    require(best["NDCG@10"] > ndcg0,
            f"NDCG@10 {best['NDCG@10']} not above the untrained {ndcg0}")
    u = rng.choice(test_users, B_KERNEL, replace=False)
    tr, te, tl = ev._tables_for(u, ITEMS)
    tables = [torch.from_numpy(x) for x in (tr, te, np.maximum(tl, 1))]
    sc = model.predict(u)
    got = ev.per_user_metrics(sc, *(x.to(dev) for x in tables))
    ref = ev.per_user_metrics(sc.cpu(), *tables)
    metric_err = float((got.cpu() - ref).abs().max())
    require(metric_err <= 1e-6, f"per-user metrics differ by {metric_err}")
    print(f"fit(): losses {losses}, NDCG@10 {ndcg0} untrained -> "
          f"{best['NDCG@10']} (Recall@10 {best['Recall@10']}); per-user "
          f"metrics of {B_KERNEL} users card vs plain route: max abs err "
          f"{metric_err}", flush=True)

    # ------------------------------------------ phase 5: ML-1M-scale catalog
    ml_root = os.path.join(root, "ml1m")
    t0 = time.perf_counter()
    ml_path = synthetic.make_dataset_dir(ml_root, num_users=ML_USERS,
                                         num_items=ML_ITEMS,
                                         num_ratings=ML_RATINGS, seed=SEED)
    ml = model_cls(RunConfig(recommender="BPRMF", data_dir=ml_path,
                             seed=SEED), {"epochs": 1, "early_stop": 1})
    require((ml.num_users, ml.num_items, ml.dataset.num_ratings)
            == (ML_USERS, ML_ITEMS, ML_RATINGS), "ML-1M catalog size")
    ml_ev = ml.evaluator
    ml_test = np.fromiter(ml_ev.user_pos_test, np.int64)
    print(f"ML-1M-scale data + model ready in {time.perf_counter() - t0:.1f}"
          f" s", flush=True)
    ml_best, ml_launches = counted(ml.fit)
    print(f"launches during ML-1M-scale fit() (1 epoch + evaluate()): "
          f"{ml_launches}")
    require(ml_launches["direct_rank"] >= 1
            and ml_launches["rank_count"] == 0,
            "the small catalog must take the direct_rank route")
    require(bool(np.isfinite(ml.history[0]["loss"])), "ML-1M loss finite")
    u = rng.choice(ml_test, B_EVAL, replace=False)
    tr, te, _ = ml_ev._tables_for(u, ML_ITEMS)
    ml_in = (ml.predict(u), torch.from_numpy(tr).to(dev),
             torch.from_numpy(te).to(dev))
    check_ranks(f"ML-1M evaluation shape B={B_EVAL}", *ml_in, K_EVAL, errs)
    print(f"ML-1M-scale: loss {ml.history[0]['loss']}, NDCG@10 "
          f"{ml_best['NDCG@10']}; direct_rank == plain at B={B_EVAL}, "
          f"T={te.shape[1]}, L={tr.shape[1]}", flush=True)

    # ----------------------------------------- phase 6: LightGCN at Gowalla
    t0 = time.perf_counter()
    reg.load_skrx_model("LightGCN")
    gcn_cls, _ = reg.get_model("LightGCN")
    gcn = gcn_cls(RunConfig(recommender="LightGCN", data_dir=path,
                            seed=SEED),
                  {"epochs": EPOCHS, "early_stop": EPOCHS})
    graph, gcfg = gcn.graph, gcn.config
    layers, gsteps = gcfg.n_layers, gcn.pipeline.num_batches
    fseg = graph.fwd
    require(graph.num_nodes == USERS + ITEMS and gcfg.embed_size == DIM
            and gcn.user_emb.device == dev and fseg.src.device == dev,
            "LightGCN at full width on the card")
    print(f"LightGCN ready in {time.perf_counter() - t0:.1f} s: "
          f"{graph.num_nodes} rows, {graph.num_edges} edges, largest "
          f"in-degree {fseg.max_degree} (mean "
          f"{graph.num_edges / graph.num_nodes}); {fseg.seg_dst.shape[0]} "
          f"segments of <= {ss.SEGMENT_EDGES} edges, "
          f"{fseg.merge_row.shape[0]} rows merged from {fseg.num_partials} "
          f"partials; {gsteps} steps an epoch", flush=True)
    # 1. the kernel against its float64 plain version, real graph and
    # adversarial ones
    ego = torch.cat([gcn.user_emb, gcn.item_emb]).detach()
    keep = torch.rand(graph.num_edges, device=dev,
                      generator=torch.Generator(dev).manual_seed(SEED)) < 0.8
    drop_mask = keep.float() / 0.8
    shares = [check_segsum(getattr(graph, direction), ego, m, msg, errs)
              for msg in MSG for direction in ("fwd", "bwd")
              for m in (None, drop_mask)]
    print(f"segsum at the Gowalla graph (D={DIM}, A and A^T, f32 and bf16 "
          f"messages, with and without a 0.8 dropout mask): worst error "
          f"{max(a for a, _ in shares)} of the bound 1e-5 sum|msg|, the f32 "
          f"plain version's {max(b for _, b in shares)}", flush=True)
    require(fseg.num_partials > 0, "the Gowalla graph has rows to merge")
    for msg in MSG:
        check_repeat(fseg, ego, drop_mask, msg)
    segsum_adversarial(dev, errs)
    # 2. the gradient of one batch's loss, card against plain on the CPU
    batch = next(gcn.pipeline.batches(epoch_generator(SEED, 0, dev)))
    params = [gcn.user_emb, gcn.item_emb]
    hyper = (layers, gcfg.reg, gcfg.batch_size)
    loss = lightgcn_loss(graph, *params, *hyper, *batch)
    grads = torch.autograd.grad(loss, params)
    cpu_params = [p.detach().cpu().requires_grad_(True) for p in params]
    loss_cpu = lightgcn_loss(graph.to("cpu"), *cpu_params, *hyper,
                             *(t.cpu() for t in batch))
    grads_cpu = torch.autograd.grad(loss_cpu, cpu_params)
    for name_, g_card, g_cpu in zip(("user_emb", "item_emb"), grads,
                                    grads_cpu):
        scale = float(g_cpu.abs().max())
        gerr = float((g_card.cpu() - g_cpu).abs().max())
        require(gerr <= 1e-5 * scale + 1e-30,
                f"{name_} gradient off by {gerr} (scale {scale})")
        print(f"gradient of one batch's loss, {name_}: max |card - plain| "
              f"{gerr}, max |grad| {scale}; loss card {float(loss.detach())}, "
              f"plain {float(loss_cpu.detach())}", flush=True)
    del grads, grads_cpu, loss, loss_cpu
    # 3. fit(): the segsum launches are counted exactly
    gcn_ndcg0 = gcn.evaluate()["NDCG@10"]
    gcn_best, gcn_launches = counted(gcn.fit)
    gcn_losses = [h["loss"] for h in gcn.history]
    evals = sum("report" in h for h in gcn.history)
    expect = EPOCHS * gsteps * 2 * layers + layers * evals
    print(f"launches during LightGCN fit() ({EPOCHS} epochs + {evals} "
          f"evaluations): {gcn_launches}; expected segsum {expect}",
          flush=True)
    require(gcn_launches["segsum"] == expect,
            f"segsum: {gcn_launches['segsum']} launches, not {expect}")
    for kname in ("submax", "kth_largest", "extract", "rank_count"):
        require(gcn_launches[kname] >= 1,
                f"{kname} never launched in LightGCN fit()")
    require(len(gcn_losses) == EPOCHS and bool(np.isfinite(gcn_losses).all())
            and gcn_losses[1] < gcn_losses[0],
            f"LightGCN losses finite and falling: {gcn_losses}")
    require(gcn_best["NDCG@10"] > gcn_ndcg0, f"LightGCN NDCG@10 "
            f"{gcn_best['NDCG@10']} not above the untrained {gcn_ndcg0}")
    print(f"LightGCN fit(): losses {gcn_losses}, NDCG@10 {gcn_ndcg0} "
          f"untrained -> {gcn_best['NDCG@10']} (Recall@10 "
          f"{gcn_best['Recall@10']})", flush=True)
    # 4. serving from the frozen propagated embeddings
    gcn_server = TopKRecommender(gcn, k=K)
    gcn_served, gcn_serve_launches = counted(lambda: [
        (u,) + gcn_server.recommend(u)
        for u in (rng.integers(0, USERS, bs) for bs in GCN_SERVE)])
    print(f"launches while serving LightGCN {GCN_SERVE}: "
          f"{gcn_serve_launches}")
    require(gcn_serve_launches["segsum"] == 0,
            "serving reuses the embeddings frozen by the last evaluate()")
    for kname in SERVING:
        require(gcn_serve_launches[kname] >= 1,
                f"{kname} never launched while serving LightGCN")
    for u, ids, vals in gcn_served:
        check_served(gcn_server, u, ids, vals, seen)
    print("LightGCN recommend == plain top-k of the same scores, no seen "
          "item", flush=True)

    # ------------------------- phase 7: fused score-and-select and chunked
    # 1. the kernels against their plain versions
    packed_s = dt.pack_items(model.item_emb, model.item_bias)
    uv_s = model.user_emb.detach()[users]
    tau_s, fcv, fci = check_fused("serving shape", uv_s, packed_s, mask, K,
                                  errs)
    for bsz in (1, 7):              # the smallest tiles and clusters
        check_fused(f"serving shape B={bsz}", uv_s[:bsz], packed_s,
                    mask[:bsz], K, errs)
    fused_eval_in = {}
    for bsz in (B_EVAL, B_KERNEL):
        u, _, tr, te, _ = eval_in[bsz]
        u_t = torch.as_tensor(u, device=dev)
        fused_eval_in[bsz] = check_fused(
            f"evaluation shape B={bsz}", model.user_emb.detach()[u_t],
            packed_s, tr, K_EVAL, errs)
        check_lookup(f"evaluation shape B={bsz}", *fused_eval_in[bsz][1:], te,
                     errs)
    fused_adversarial(dev, model.item_emb.detach(), errs)
    print(f"fused kernels == plain versions (max abs err "
          f"{ {k: errs.get(k, 0.0) for k in FUSED + ('rank_lookup_count',)} }"
          f"); evaluation tables T={t_eval}, L={l_eval}", flush=True)
    # 2. fused serving
    fused_launches = {}
    for tag, m in (("BPRMF", model), ("LightGCN", gcn)):
        fsrv = TopKRecommender(m, k=K, fused="always")
        require(fsrv.fused, f"{tag}: a dot model takes the fused route")
        answers, launched = counted(lambda: [
            serve_measured(fsrv, rng.integers(0, USERS, bs))
            for bs in GCN_SERVE])
        fused_launches[tag] = launched
        differ = [check_fused_served(fsrv, *a, seen) for a in answers]
        print(f"fused serving {tag} {GCN_SERVE}: launches {launched}; rows "
              f"unlike the score-matrix route {differ}", flush=True)
        for kname in FUSED + ("kth_largest", "pruned_merge"):
            require(launched[kname] >= 1,
                    f"{kname} never launched in fused serving of {tag}")
        require(launched["submax"] == launched["extract"] == 0,
                "fused serving built a score matrix")
    # 3. fused and chunked evaluate()
    eval_runs = {}
    for tag, m, modes in (("BPRMF", model, ("full", "fused", "chunked")),
                          ("LightGCN", gcn, ("full", "fused"))):
        for mode in modes:
            (rep, sec), launched = counted(lambda: evaluate_as(m, mode, CHUNK))
            eval_runs[tag, mode] = (rep, sec, launched)
        full = np.array(list(eval_runs[tag, "full"][0].values()))
        for mode in modes[1:]:
            rep, sec, launched = eval_runs[tag, mode]
            diff = float(np.abs(np.array(list(rep.values())) - full).max())
            print(f"{tag} evaluate() eval_mode={mode!r}: {sec} s, NDCG@10 "
                  f"{rep['NDCG@10']} (full {eval_runs[tag, 'full'][0]['NDCG@10']}"
                  f"), largest metric difference to the full route {diff}; "
                  f"launches {launched}", flush=True)
            require(diff <= 1e-4, f"{tag} {mode}: metrics off by {diff}")
            need = (FUSED + ("kth_largest", "rank_lookup_count")
                    if mode == "fused" else ("pruned_merge",))
            for kname in need:
                require(launched[kname] >= 1,
                        f"{kname} never launched in {mode} evaluate() of {tag}")
            require(launched["rank_count"] == 0,
                    f"{mode} evaluate() took the full route")
    # 4. a catalog that only the fused route serves cheaply
    gen = torch.Generator(dev).manual_seed(SEED)
    big_items = torch.randn((BIG_ITEMS, DIM), device=dev, generator=gen)
    big_bias = torch.randn((BIG_ITEMS,), device=dev, generator=gen)
    big_uv = torch.randn((BIG_B, DIM), device=dev, generator=gen)
    big_seen = torch.randint(0, BIG_ITEMS, (BIG_B, 300), device=dev,
                             generator=gen, dtype=torch.int32)
    big_seen[:, -20:] = BIG_ITEMS                       # padding
    big_packed, pack_peak = peak_above(
        lambda: dt.pack_items(big_items, big_bias))
    (bv, bi), big_fused_peak = peak_above(lambda: dt.dot_topk(
        big_uv, None, None, K, mask_table=big_seen, packed=big_packed))
    rv, ri = dt.dot_topk_plain(big_uv, big_packed, K, big_seen)
    expect_equal(f"dot_topk N={BIG_ITEMS}", [bv, bi], [rv.cpu(), ri.cpu()],
                 errs, "dot_extract")
    del rv, ri
    _, big_matrix_peak = peak_above(lambda: tb.blockwise_topk(
        torch.matmul(big_uv, big_items.T) + big_bias, K,
        mask_table=big_seen))
    print(f"catalog of {BIG_ITEMS} items, B={BIG_B}, d={DIM}: dot_topk == "
          f"plain; peak device memory above the allocated: fused "
          f"{big_fused_peak} B (packing the table once {pack_peak} B), "
          f"score-matrix route {big_matrix_peak} B", flush=True)
    require(big_fused_peak < 4 * BIG_B * BIG_ITEMS,
            "the fused route must allocate less than one score matrix")

    # ------------------------------------------------------ phase 8: times
    b, n, w_sub, w_c = B_KERNEL, ITEMS, bmf.shape[1], cv.shape[1]
    s_masked = tb._masked_padded(scores, mask, BLOCK_N).reshape(b, -1, BLOCK_N)
    found = ((s_masked >= tau[:, None, None]) & (s_masked != NEG_INF)).sum(2)
    del s_masked
    # rank_count at the evaluation batch of the Gowalla route;
    # rank_lookup_count on the fused candidates of the same batch
    e_u, e_sc, e_tr, e_te, e_tl = eval_in[B_EVAL]
    _, l_cv, l_ci = fused_eval_in[B_EVAL]
    w_l = l_cv.shape[1]
    e_cv, e_ci, _ = tb.blockwise_candidates(e_sc, K_EVAL, BLOCK_N, e_tr)
    e_st = e_sc.gather(1, e_te.clamp(0, ITEMS - 1).long())
    be, w_r = e_sc.shape[0], e_cv.shape[1]
    # direct_rank at the evaluation batch of the ML-1M route; its work
    # counts the probes that are found (in range, unmasked, finite)
    m_sc, m_tr, m_te = ml_in
    m_safe = m_te.clamp(0, ML_ITEMS - 1)
    m_valid = int(((m_te >= 0) & (m_te < ML_ITEMS)
                   & ~tb._in_rows(m_tr, m_safe)
                   & torch.isfinite(m_sc.gather(1, m_safe.long()))).sum())
    bm_, tm_, lm_ = m_sc.shape[0], m_te.shape[1], m_tr.shape[1]
    # segsum at the Gowalla graph, forward (A) on the ego embeddings as in
    # the first layer of a training step
    n_rows, n_edges, n_seg = graph.num_nodes, graph.num_edges, \
        fseg.seg_dst.shape[0]
    n_part, n_merge = fseg.num_partials, fseg.merge_row.shape[0]
    # the CSR matrix of A (the segments' edges in row order)
    by_row = torch.argsort(fseg.dst, stable=True)
    crow = torch.zeros(n_rows + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(fseg.dst.long(),
                                           minlength=n_rows), 0)
    a_csr = torch.sparse_csr_tensor(crow, fseg.src[by_row].long(),
                                    fseg.weight[by_row], (n_rows, n_rows))
    require(bool(torch.allclose(torch.sparse.mm(a_csr, ego),
                                ss.segsum(fseg, ego), rtol=1e-4, atol=1e-6)),
            "torch.sparse.mm of the CSR matrix computes the same function")
    work = {   # (bytes moved, operations) for this run's inputs
        "submax": (4 * (b * n + b * seen_w + b * w_sub), b * n),
        "kth_largest": (4 * (b * w_sub + b), 2 * 33 * b * w_sub),
        "extract": (4 * (b * n + b * seen_w + b) + 8 * b * w_c,
                    b * n + select_ops(found, K)),
        "pruned_merge": (8 * b * w_c + 4 * b + 8 * b * K, 2 * K * b * w_c),
        # a compare and an add per (probe, candidate) pair
        "rank_count": (8 * be * w_r + 12 * be * t_eval,
                       2 * be * t_eval * w_r),
        # a compare and an add per (found probe, column) pair
        "direct_rank": (4 * (bm_ * ML_ITEMS + bm_ * lm_ + 2 * bm_ * tm_),
                        2 * m_valid * ML_ITEMS),
        # x once, each edge's source id and weight, the segment and merge
        # tables, the counters read and reset, the output written (partial
        # rows are the kernel's scratch); a multiply and an add per (edge,
        # feature), an add per partial feature
        "segsum": (4 * (2 * n_rows * DIM + 2 * n_edges + 2 * n_seg + 1
                        + n_part + 4 * n_merge + 1),
                   2 * n_edges * DIM + n_part * DIM),
        # uv, the item table and bias once, the seen table, the maxima
        # written; a multiply and an add per (row, item, dimension)
        "dot_submax": (4 * (b * DIM + n * DIM + n + b * seen_w + b * w_sub),
                       2 * b * n * DIM),
        "dot_extract": (4 * (b * DIM + n * DIM + n + b * seen_w + b)
                        + 8 * b * w_c, 2 * b * n * DIM),
        # the candidates and probes once, ranks and found written; per
        # (probe, candidate) pair a compare and a max (lookup), a compare
        # and an add (count)
        "rank_lookup_count": (8 * be * w_l + 4 * be * t_eval + 5 * be * t_eval,
                              4 * be * t_eval * w_l),
    }
    # the whole propagate as a user calls it: x, the CSR arrays (row
    # offsets, source ids, weights) and the output
    prop_bytes = 4 * (2 * n_rows * DIM + n_rows + 1 + 2 * n_edges)
    neg = torch.full_like(tau, NEG_INF)
    kernel_fns = {
        "submax": (lambda: tb.submax(scores, mask, BLOCK_N),
                   lambda: tb.submax_plain(scores, mask, BLOCK_N), None),
        "kth_largest": (lambda: tb.kth_largest(bmf, K),
                        lambda: tb.kth_largest_plain(bmf, K),
                        lambda: torch.kthvalue(bmf, w_sub - K + 1, dim=1)),
        "extract": (lambda: tb.extract(scores, tau, K, mask, BLOCK_N),
                    lambda: tb.extract_plain(scores, mask, tau, K, BLOCK_N),
                    None),
        "pruned_merge": (lambda: tb.pruned_merge(cv, ci, K, tau),
                         lambda: tb.pruned_merge_plain(cv, ci, K, tau),
                         lambda: torch.topk(cv, K, dim=1)),
        "rank_count": (lambda: tb.rank_count(e_cv, e_ci, e_st, e_te),
                       lambda: tb.rank_count_plain(e_cv, e_ci, e_st, e_te),
                       None),
        "direct_rank": (lambda: tb.direct_rank(m_sc, m_te, K_EVAL, m_tr),
                        lambda: tb.direct_rank_plain(m_sc, m_tr, m_te,
                                                     K_EVAL), None),
        "segsum": (lambda: ss.segsum(fseg, ego),
                   lambda: ss.segsum_plain(fseg, ego),
                   lambda: torch.sparse.mm(a_csr, ego)),
        # no single PyTorch call computes these; the fused top-k as a
        # whole is held against matmul + mask_items + torch.topk below
        "dot_submax": (lambda: dt.dot_submax(uv_s, packed_s, mask),
                       lambda: dt.dot_submax_plain(uv_s, packed_s, mask),
                       None),
        "dot_extract": (
            lambda: dt.dot_extract(uv_s, packed_s, tau_s, K, mask),
            lambda: dt.dot_extract_plain(uv_s, packed_s, mask, tau_s, K),
            None),
        "rank_lookup_count": (
            lambda: tb.rank_lookup_count(l_cv, l_ci, e_te),
            lambda: tb.rank_lookup_count_plain(l_cv, l_ci, e_te), None),
    }
    # launches over every main-path run of this script: serving, both
    # fit()s at Gowalla, the ML-1M-scale fit(), LightGCN serving, fused
    # serving, and the fused and chunked evaluate() calls
    path_runs = [serve_launches, fit_launches, ml_launches, gcn_launches,
                 gcn_serve_launches, *fused_launches.values(),
                 *(r[2] for r in eval_runs.values())]
    launches = {k: sum(r[k] for r in path_runs) for k in runtime.KERNELS}
    shapes = {k: f"B={b}, N={n}, k={K}, L={seen_w}" for k in SERVING}
    for kname in FUSED:
        shapes[kname] = f"B={b}, N={n}, d={DIM}, k={K}, L={seen_w}"
    shapes["rank_lookup_count"] = (f"B={be}, N={ITEMS}, k={K_EVAL}, W={w_l}, "
                                   f"T={t_eval}")
    shapes["rank_count"] = (f"B={be}, N={ITEMS}, k={K_EVAL}, W={w_r}, "
                            f"T={t_eval}")
    shapes["direct_rank"] = (f"B={bm_}, N={ML_ITEMS}, k={K_EVAL}, L={lm_}, "
                             f"T={tm_}, found {m_valid}")
    shapes["segsum"] = (f"N={n_rows}, E={n_edges}, D={DIM}, {n_seg} "
                        f"segments, {n_merge} rows merged from {n_part} "
                        f"partial rows")
    rows = []
    for kname in runtime.KERNELS:
        fn, plain, lib = kernel_fns[kname]
        nbytes, ops = work[kname]
        t_bytes, t_ops = nbytes / MEM_RATE * 1e3, ops / F32_OPS * 1e3
        row = {"name": kname, "route": "cuda", "source": SOURCE[kname],
               "replaces": REPLACES[kname], "launches": launches[kname],
               "max_abs_err": errs.get(kname, 0.0),
               "ms": device_ms(fn),
               "plain_ms": device_ms(plain),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": None if lib is None else device_ms(lib)}
        rows.append(row)
        print(f"{kname:13s} {row['ms']} ms  bound {row['bound_ms']} ms "
              f"({row['bound_by']})  plain {row['plain_ms']} ms  library "
              f"{row['library_ms']}  (device time per call); one wrapper "
              f"call between CUDA events {time_ms(fn)} ms, plain "
              f"{time_ms(plain)} ms; 200 back-to-back calls between CUDA "
              f"events {launches_ms(fn)} ms a call; launches on its path "
              f"{launches[kname]}  [{card}, {shapes[kname]}]", flush=True)
    prop_bound = max(prop_bytes / MEM_RATE, 2 * n_edges * DIM / F32_OPS) * 1e3
    print(f"propagate at the Gowalla graph (segsum, one launch with its "
          f"merge pass, as a user calls it): f32 messages {device_ms(lambda: ss.segsum(fseg, ego))}"
          f" ms, bf16 messages "
          f"{device_ms(lambda: ss.segsum(fseg, ego, None, torch.bfloat16))} "
          f"ms, with a dropout mask "
          f"{device_ms(lambda: ss.segsum(fseg, ego, drop_mask))} ms of device "
          f"time; one call between CUDA events "
          f"{time_ms(lambda: ss.segsum(fseg, ego))} ms; bound "
          f"{prop_bound} ms (bytes, {prop_bytes} B: x, CSR, output) "
          f"[{card}, {shapes['segsum']}]", flush=True)
    n_full = ITEMS // BLOCK_N * BLOCK_N
    two_calls = device_ms(lambda: torch.amax(metrics.mask_items(
        scores, mask)[:, :n_full].reshape(b, -1, BLOCK_N // 128, 128), dim=2))
    vmem_ms = (device_ms(lambda: tb.pruned_merge(cv, ci, K, neg)),
               time_ms(lambda: tb.pruned_merge(cv, ci, K, neg)))
    total = time_ms(lambda: tb.blockwise_topk(scores, K, mask_table=mask))

    def masked_topk():
        return torch.topk(metrics.mask_items(scores, mask), K, dim=1)
    print(f"submax yardstick, two calls (mask_items + amax over the "
          f"{n_full // BLOCK_N} full column blocks): {two_calls} ms of "
          f"device time; "
          f"vmem_topk (tau=-inf) {vmem_ms[0]} ms of device time, "
          f"{vmem_ms[1]} ms between CUDA events; blockwise_topk total "
          f"{total} ms vs masked torch.topk {time_ms(masked_topk)} ms; "
          f"predict {time_ms(lambda: model.predict(users))} ms "
          f"[{card}, B={b}]")
    # vmem_topk (#5) at its own shape, chunked evaluate()'s merge: the
    # running best (B=64, k=50) beside one chunk's top 50
    tops = [torch.topk(e_sc[:, lo:lo + CHUNK], K_EVAL, dim=1)
            for lo in (0, CHUNK)]
    c_v = torch.cat([t.values for t in tops], 1).contiguous()
    c_i = torch.cat([tops[0].indices, tops[1].indices + CHUNK],
                    1).to(torch.int32).contiguous()
    neg_e = torch.full((be,), NEG_INF, device=dev)
    w_m = c_v.shape[1]
    t_bytes = (8 * be * w_m + 4 * be + 8 * be * K_EVAL) / MEM_RATE * 1e3
    t_ops = 2 * K_EVAL * be * w_m / F32_OPS * 1e3
    expect_equal("vmem_topk at the chunk-merge shape",
                 tb.vmem_topk(c_v, c_i, K_EVAL),
                 tb.pruned_merge_plain(c_v.cpu(), c_i.cpu(), K_EVAL,
                                       neg_e.cpu()), errs, "pruned_merge")
    print(f"vmem_topk (pruned_merge, tau=-inf) at the chunked-evaluation "
          f"merge (B={be}, W={w_m}, k={K_EVAL}): "
          f"{device_ms(lambda: tb.vmem_topk(c_v, c_i, K_EVAL))} ms of device "
          f"time, bound {max(t_bytes, t_ops)} ms ("
          f"{'bytes' if t_bytes >= t_ops else 'operations'}), plain "
          f"{device_ms(lambda: tb.pruned_merge_plain(c_v, c_i, K_EVAL, neg_e))}"
          f" ms, library torch.topk "
          f"{device_ms(lambda: torch.topk(c_v, K_EVAL, dim=1))} ms  [{card}]",
          flush=True)
    # the fused top-k as a whole, beside the score-matrix route and the
    # library yardstick; the fused kernels at the evaluation batch
    def matrix_topk(uv, items, bias, seen_rows):
        return tb.blockwise_topk(torch.matmul(uv, items.T) + bias, K,
                                 mask_table=seen_rows)
    item_w, item_b = model.item_emb.detach(), model.item_bias.detach()
    for tag, fused_fn, matrix_fn, lib_fn in (
            (f"B={b}, N={n}",
             lambda: dt.dot_topk(uv_s, None, None, K, mask, packed=packed_s),
             lambda: matrix_topk(uv_s, item_w, item_b, mask),
             lambda: torch.topk(metrics.mask_items(
                 torch.matmul(uv_s, item_w.T) + item_b, mask), K, dim=1)),
            (f"B={BIG_B}, N={BIG_ITEMS}",
             lambda: dt.dot_topk(big_uv, None, None, K, big_seen,
                                 packed=big_packed),
             lambda: matrix_topk(big_uv, big_items, big_bias, big_seen),
             lambda: torch.topk(metrics.mask_items(
                 torch.matmul(big_uv, big_items.T) + big_bias, big_seen), K,
                 dim=1))):
        print(f"top-{K} {tag}, d={DIM}: fused dot_topk {device_ms(fused_fn)} "
              f"ms of device time ({time_ms(fused_fn)} ms between CUDA "
              f"events); score-matrix route (matmul + blockwise_topk) "
              f"{device_ms(matrix_fn)} ms ({time_ms(matrix_fn)}); library "
              f"yardstick matmul + mask_items + torch.topk "
              f"{device_ms(lib_fn)} ms ({time_ms(lib_fn)})  [{card}]",
              flush=True)
    # the selection kernels at the evaluation batch (B=64, k=50), where 934
    # of the fused kernels' launches and nearly all of kth_largest's are
    e_uv = model.user_emb.detach()[torch.as_tensor(e_u, device=dev)]
    e_tau_f = fused_eval_in[B_EVAL][0]
    e_bm = tb.submax(e_sc, e_tr, BLOCK_N)
    e_bmf = tb.fold_submaxes(e_bm, K_EVAL).contiguous()
    sel_tau = tb.kth_largest(e_bmf, K_EVAL)
    sel_cv, _ = tb.extract(e_sc, sel_tau, K_EVAL, e_tr, BLOCK_N)
    sel_masked = tb._masked_padded(e_sc, e_tr, BLOCK_N).reshape(be, -1, BLOCK_N)
    sel_found = ((sel_masked >= sel_tau[:, None, None])
                 & (sel_masked != NEG_INF)).sum(2)
    del sel_masked
    w_e, w_f, w_ce = e_bm.shape[1], e_bmf.shape[1], sel_cv.shape[1]
    eval_work = {   # (bytes, operations), the kernel, a library call
        "submax": ((4 * (be * n + be * l_eval + be * w_e), be * n),
                   lambda: tb.submax(e_sc, e_tr, BLOCK_N), None),
        "kth_largest": ((4 * (be * w_f + be), 2 * 33 * be * w_f),
                        lambda: tb.kth_largest(e_bmf, K_EVAL),
                        lambda: torch.kthvalue(e_bmf, w_f - K_EVAL + 1,
                                               dim=1)),
        "extract": ((4 * (be * n + be * l_eval + be) + 8 * be * w_ce,
                     be * n + select_ops(sel_found, K_EVAL)),
                    lambda: tb.extract(e_sc, sel_tau, K_EVAL, e_tr, BLOCK_N),
                    None),
        "dot_submax": ((4 * (be * DIM + n * DIM + n + be * l_eval
                             + be * w_e), 2 * be * n * DIM),
                       lambda: dt.dot_submax(e_uv, packed_s, e_tr), None),
        "dot_extract": ((4 * (be * DIM + n * DIM + n + be * l_eval + be)
                         + 8 * be * w_ce, 2 * be * n * DIM),
                        lambda: dt.dot_extract(e_uv, packed_s, e_tau_f,
                                               K_EVAL, e_tr), None),
    }
    for kname, ((nbytes, ops), fn, lib) in eval_work.items():
        t_bytes, t_ops = nbytes / MEM_RATE * 1e3, ops / F32_OPS * 1e3
        print(f"{kname:13s} at the evaluation shape (B={be}, N={n}, "
              f"k={K_EVAL}, W={w_e} (folded {w_f}), L={l_eval}): "
              f"{device_ms(fn)} ms of device time, bound "
              f"{max(t_bytes, t_ops)} ms ("
              f"{'bytes' if t_bytes >= t_ops else 'operations'}); library "
              f"{None if lib is None else device_ms(lib)} ms; 200 "
              f"back-to-back calls between CUDA events {launches_ms(fn)} ms "
              f"a call  [{card}]", flush=True)
    print(f"direct_rank at the ML-1M evaluation shape: {device_ms(kernel_fns['direct_rank'][0])} "
          f"ms of device time (torch.profiler, the table's number), "
          f"{launches_ms(kernel_fns['direct_rank'][0], 1000)} ms a call over "
          f"1,000 back-to-back calls between CUDA events (the host's launch "
          f"rate where it is the slower), {time_ms(kernel_fns['direct_rank'][0])} "
          f"ms for one call between CUDA events  [{card}]", flush=True)
    print(f"dot_topk_ranks at the evaluation batch B={be}: "
          f"{time_ms(lambda: dt.dot_topk_ranks(e_uv, None, None, K_EVAL, e_te, e_tr, packed=packed_s))}"
          f" ms between CUDA events  [{card}]", flush=True)
    ranks_ms = time_ms(lambda: tb.masked_topk_ranks(e_sc, K_EVAL, e_te, e_tr))
    metrics_ms = time_ms(lambda: ev.per_user_metrics(e_sc, e_tr, e_te,
                                                     e_tl))
    print(f"evaluation batch B={be}: masked_topk_ranks {ranks_ms} ms, "
          f"per-user metrics (ranks included) {metrics_ms} ms, predict "
          f"{time_ms(lambda: model.predict(e_u))} ms [{card}]")
    fused_server = TopKRecommender(model, k=K, fused="always")
    for bs in BATCHES:
        u = rng.integers(0, USERS, bs)
        for route, srv in (("score matrix", server), ("fused", fused_server)):
            lat = []
            for _ in range(35):
                t0 = time.perf_counter()
                srv.recommend(u)
                lat.append((time.perf_counter() - t0) * 1e3)
            lat = np.sort(lat[5:])
            busy, _ = busy_share(lambda: srv.recommend(u))
            print(f"recommend B={bs:5d} {route:12s}: p50 {lat[len(lat) // 2]}"
                  f" ms  max {lat[-1]} ms  device busy "
                  f"{'not measured' if busy is None else busy}  [{card}]")
    # training and evaluation, end to end
    for tag, m in (("Gowalla", model), ("LightGCN Gowalla", gcn)):
        steps = m.pipeline.num_batches
        for h in m.history:
            print(f"{tag} epoch {h['epoch']}: train {h['train_seconds']} s "
                  f"({steps / h['train_seconds']} steps/s of batch "
                  f"{m.config.batch_size}), evaluate() {h['eval_seconds']} "
                  f"s  [{card}]")
    for tag, m, n_users in (("Gowalla", model, len(test_users)),
                            ("ML-1M", ml, len(ml_test)),
                            ("LightGCN Gowalla", gcn, len(test_users))):
        _, sec = timed(m.evaluate)
        _, per_eval = counted(m.evaluate)
        print(f"{tag} evaluate(): {sec} s, {n_users / sec} users/s, "
              f"launches per evaluate() {per_eval}  [{card}]")
        busy, heads = busy_share(m.evaluate, reps=1, warm=False, top=6)
        print(f"{tag} evaluate() device busy {busy}; top device kernels "
              f"(ms): {heads}")
        modes = {model: ("fused", "chunked"), gcn: ("fused",)}.get(m, ())
        for mode in modes:
            (_, sec) = evaluate_as(m, mode, CHUNK)
            busy, heads = busy_share(lambda: evaluate_as(m, mode, CHUNK),
                                     reps=1, warm=False, top=6)
            print(f"{tag} evaluate() eval_mode={mode!r}: {sec} s, "
                  f"{n_users / sec} users/s; device busy {busy}; top device "
                  f"kernels (ms): {heads}  [{card}]")
        busy, heads = busy_share(lambda: m._train_epoch(99), reps=1,
                                 warm=False, top=6)
        print(f"{tag} train epoch device busy {busy}; top device kernels "
              f"(ms): {heads}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30} "
          f"GiB")
    shutil.rmtree(root, ignore_errors=True)

    print(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
