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
   T=1 and T>128, rows with fewer than k unmasked items. Selection and
   counting do no arithmetic, so values, ids and ranks must be equal.
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
6. Times on the card: each kernel, its plain version and a library call
   where one computes the same function, as device time per call
   (torch.profiler, 50 calls after warm-up) and as the median time of one
   call between CUDA events (host launch gaps included); the kernel's
   bound; recommend's p50 per batch size with the
   card's busy share during it (torch.profiler); train steps/s, seconds per
   epoch and evaluation users/s with the busy share and the top device
   kernels of one epoch and one evaluate().

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
from skrx_torch.ops import metrics
from skrx_torch.ops.kernels import _build
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
              direct_rank="skrx_torch/ops/kernels/csrc/rank_counts.cu")
REPLACES = {"submax": "skrx/ops/pallas/topk_blocks.py:488",
            "kth_largest": "skrx/ops/pallas/topk_blocks.py:224",
            "extract": "skrx/ops/pallas/topk_blocks.py:601",
            "pruned_merge": "skrx/ops/pallas/topk_blocks.py:295",
            "rank_count": "skrx/ops/pallas/topk_blocks.py:815",
            "direct_rank": "skrx/ops/pallas/topk_blocks.py:935"}
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
    # signed zeros, subnormals and -inf rows for the bisection
    x = np.zeros((8, 1408), np.float32)
    x[0, :5] = [-0.0, 0.0, 1e-40, -1e-40, 5e-324]
    x[1] = -0.0
    x[2] = NEG_INF
    for k in (1, 3, K):
        expect_equal("kth_largest zeros",
                     [tb.kth_largest(t(x), k).view(torch.int32)],
                     [tb.kth_largest_plain(t(x).cpu(), k).view(torch.int32)],
                     errs, "kth_largest")


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
    Unlike time_ms it leaves out the idle gaps while the host launches,
    which dominate a kernel of a few microseconds. A profile now and then
    records no device event at all; it is taken again, and after three
    empty ones the CUDA-event time of time_ms stands in (a line says so)."""
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
    tb.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(tb.LAUNCHES)


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
    _build.load("topk_blocks")
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
        require(ids.shape == vals.shape == (len(u), K)
                and np.isfinite(vals).all(), "finite (B, k) answers")
        s_cpu = model.predict(u).cpu()
        m_cpu = server._seen[torch.as_tensor(u, device=dev)].cpu()
        ref_v, ref_i = tb.blockwise_topk(s_cpu, K, mask_table=m_cpu)
        np.testing.assert_array_equal(ids, ref_i.numpy())
        np.testing.assert_array_equal(vals, ref_v.numpy())
        sort_v, sort_i = metrics.topk_scores_and_indices(s_cpu, K, m_cpu)
        np.testing.assert_array_equal(ids, sort_i.numpy())
        for user, row in zip(u, ids):
            require(not np.isin(row, seen.get(int(user), [])).any(),
                    f"user {user} got a seen item")
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

    # ------------------------------------------------------ phase 6: times
    b, n, w_sub, w_c = B_KERNEL, ITEMS, bmf.shape[1], cv.shape[1]
    s_masked = tb._masked_padded(scores, mask, BLOCK_N).reshape(b, -1, BLOCK_N)
    found = ((s_masked >= tau[:, None, None]) & (s_masked != NEG_INF)).sum(2)
    del s_masked
    # rank_count at the evaluation batch of the Gowalla route
    e_u, e_sc, e_tr, e_te, e_tl = eval_in[B_EVAL]
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
    work = {   # (bytes moved, operations) for this run's inputs
        "submax": (4 * (b * n + b * seen_w + b * w_sub), b * n),
        "kth_largest": (4 * (b * w_sub + b), 2 * 33 * b * w_sub),
        "extract": (4 * (b * n + b * seen_w + b) + 8 * b * w_c,
                    b * n + int((found.clamp(max=K) * found).sum())),
        "pruned_merge": (8 * b * w_c + 4 * b + 8 * b * K, 2 * K * b * w_c),
        # a compare and an add per (probe, candidate) pair
        "rank_count": (8 * be * w_r + 12 * be * t_eval,
                       2 * be * t_eval * w_r),
        # a compare and an add per (found probe, column) pair
        "direct_rank": (4 * (bm_ * ML_ITEMS + bm_ * lm_ + 2 * bm_ * tm_),
                        2 * m_valid * ML_ITEMS),
    }
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
    }
    launches = {k: serve_launches[k] for k in SERVING}
    launches.update(rank_count=fit_launches["rank_count"],
                    direct_rank=ml_launches["direct_rank"])
    shapes = {k: f"B={b}, N={n}, k={K}, L={seen_w}" for k in SERVING}
    shapes["rank_count"] = (f"B={be}, N={ITEMS}, k={K_EVAL}, W={w_r}, "
                            f"T={t_eval}")
    shapes["direct_rank"] = (f"B={bm_}, N={ML_ITEMS}, k={K_EVAL}, L={lm_}, "
                             f"T={tm_}, found {m_valid}")
    rows = []
    for kname in tb.KERNELS:
        fn, plain, lib = kernel_fns[kname]
        nbytes, ops = work[kname]
        t_bytes, t_ops = nbytes / MEM_RATE * 1e3, ops / F32_OPS * 1e3
        row = {"name": kname, "route": "cuda", "source": SOURCE[kname],
               "replaces": REPLACES[kname], "launches": launches[kname],
               "max_abs_err": errs.get(kname, 0.0), "ms": device_ms(fn),
               "plain_ms": device_ms(plain),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": None if lib is None else device_ms(lib)}
        rows.append(row)
        print(f"{kname:13s} {row['ms']} ms  bound {row['bound_ms']} ms "
              f"({row['bound_by']})  plain {row['plain_ms']} ms  library "
              f"{row['library_ms']}  (device time per call); one wrapper "
              f"call between CUDA events {time_ms(fn)} ms, plain "
              f"{time_ms(plain)} ms; launches on its path "
              f"{launches[kname]}  [{card}, {shapes[kname]}]", flush=True)
    n_full = ITEMS // BLOCK_N * BLOCK_N
    two_calls = device_ms(lambda: torch.amax(metrics.mask_items(
        scores, mask)[:, :n_full].reshape(b, -1, BLOCK_N // 128, 128), dim=2))
    vmem_ms = time_ms(lambda: tb.pruned_merge(cv, ci, K, neg))
    total = time_ms(lambda: tb.blockwise_topk(scores, K, mask_table=mask))

    def masked_topk():
        return torch.topk(metrics.mask_items(scores, mask), K, dim=1)
    print(f"submax yardstick, two calls (mask_items + amax over the "
          f"{n_full // BLOCK_N} full column blocks): {two_calls} ms of "
          f"device time; "
          f"vmem_topk (tau=-inf) {vmem_ms} ms; blockwise_topk total "
          f"{total} ms vs masked torch.topk {time_ms(masked_topk)} ms; "
          f"predict {time_ms(lambda: model.predict(users))} ms "
          f"[{card}, B={b}]")
    ranks_ms = time_ms(lambda: tb.masked_topk_ranks(e_sc, K_EVAL, e_te, e_tr))
    metrics_ms = time_ms(lambda: ev.per_user_metrics(e_sc, e_tr, e_te,
                                                     e_tl))
    print(f"evaluation batch B={be}: masked_topk_ranks {ranks_ms} ms, "
          f"per-user metrics (ranks included) {metrics_ms} ms, predict "
          f"{time_ms(lambda: model.predict(e_u))} ms [{card}]")
    for bs in BATCHES:
        u = rng.integers(0, USERS, bs)
        lat = []
        for _ in range(35):
            t0 = time.perf_counter()
            server.recommend(u)
            lat.append((time.perf_counter() - t0) * 1e3)
        lat = np.sort(lat[5:])
        busy, _ = busy_share(lambda: server.recommend(u))
        print(f"recommend B={bs:5d}: p50 {lat[len(lat) // 2]} ms  "
              f"max {lat[-1]} ms  device busy "
              f"{'not measured' if busy is None else busy}  [{card}]")
    # training and evaluation, end to end
    steps = model.pipeline.num_batches
    for h in model.history:
        print(f"Gowalla epoch {h['epoch']}: train {h['train_seconds']} s "
              f"({steps / h['train_seconds']} steps/s of batch "
              f"{model.config.batch_size}), evaluate() {h['eval_seconds']} s"
              f"  [{card}]")
    for tag, m, n_users in (("Gowalla", model, len(test_users)),
                            ("ML-1M", ml, len(ml_test))):
        _, sec = timed(m.evaluate)
        _, per_eval = counted(m.evaluate)
        print(f"{tag} evaluate(): {sec} s, {n_users / sec} users/s, "
              f"launches per evaluate() {per_eval}  [{card}]")
        busy, heads = busy_share(m.evaluate, reps=1, warm=False, top=6)
        print(f"{tag} evaluate() device busy {busy}; top device kernels "
              f"(ms): {heads}")
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
