"""Smoke run of the PyTorch/CUDA port (skrx_torch) on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with a card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; without CUDA it exits 2
before doing anything):

1. Environment: the card's name and power limit (nvidia-smi), the torch
   version, TF32 off for f32 matmuls, and the nvcc build of the kernels.
2. Every kernel of the serving path against its plain PyTorch version on a
   CPU copy of the same inputs, at the slice shape (B=1024 users, the
   40,981-item catalog, k=10, the seen-table width of the generated data)
   and on adversarial inputs: tie storms, fully masked rows, -inf rows,
   duplicate candidates, signed zeros. Selection does no arithmetic, so
   values and ids must be equal.
3. The slice: Gowalla-scale synthetic data (29,858 users, 40,981 items,
   1,027,370 interactions), BPRMF (n_dim=64, random weights from a seed)
   built by name on cuda, TopKRecommender.recommend for batches of 1, 16,
   64, 256 and 1024 users. The launch counts are reset just before and read
   just after; every kernel must have launched. Each answer must equal the
   plain top-k of the same scores on the CPU and hold no seen item.
4. Times on the card (CUDA events, median of 50 after warm-up): each
   kernel, its plain version, a library call where one computes the same
   function, the kernel's bound, and recommend's p50 per batch size with
   the card's busy share during it (torch.profiler).

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
BATCHES = (1, 16, 64, 256, 1024)
B_KERNEL = 1024
BLOCK_N = 4096
SEED = 2021
REPS = 50
SOURCE = "skrx_torch/ops/kernels/csrc/topk_blocks.cu"
REPLACES = {"submax": "skrx/ops/pallas/topk_blocks.py:488",
            "kth_largest": "skrx/ops/pallas/topk_blocks.py:224",
            "extract": "skrx/ops/pallas/topk_blocks.py:601",
            "pruned_merge": "skrx/ops/pallas/topk_blocks.py:295"}
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


def busy_share(fn, reps: int = 20):
    """Share of the host-clock time of ``reps`` calls of fn in which the
    card ran a kernel or a copy (sum of device event times from
    torch.profiler over the wall time; the profiler slows the host, so this
    is a lower bound). None when the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    return busy_us / wall_us if busy_us > 0 else None


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
                                seed=SEED), {"n_dim": DIM})
    require((model.num_users, model.num_items, model.dataset.num_ratings)
            == (USERS, ITEMS, RATINGS), "catalog size")
    require(model.user_emb.device == dev
            and model.item_emb.shape == (ITEMS, DIM), "model on the card")
    server = TopKRecommender(model, k=K)
    seen_w = server._seen.shape[1]
    print(f"data + model ready in {time.perf_counter() - t0:.1f} s: "
          f"{USERS} users, {ITEMS} items, {RATINGS} interactions, "
          f"seen-table width {seen_w}")

    # ------------------------------------------- phase 2: kernels vs plain
    rng = np.random.default_rng(SEED + 1)
    errs: dict = {}
    users = torch.as_tensor(rng.integers(0, USERS, B_KERNEL), device=dev)
    scores = model.predict(users)
    mask = server._seen[users]
    bmf, tau, cv, ci = check_chain("slice shape", scores, mask, K, errs)
    adversarial(dev, errs)
    print(f"kernels == plain versions (max abs err {errs})", flush=True)

    # ------------------------------------------------------ phase 3: slice
    served = []
    torch.cuda.synchronize()
    tb.reset_launches()
    for bs in BATCHES:
        u = rng.integers(0, USERS, bs)
        served.append((u,) + server.recommend(u))
    launches = dict(tb.LAUNCHES)
    print(f"launches while serving {len(BATCHES)} requests: {launches}")
    for kname in tb.KERNELS:
        require(launches[kname] >= 1,
                f"{kname} never launched on the main path")
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

    # ------------------------------------------------------ phase 4: times
    b, n, w_sub, w_c = B_KERNEL, ITEMS, bmf.shape[1], cv.shape[1]
    s_masked = tb._masked_padded(scores, mask, BLOCK_N).reshape(b, -1, BLOCK_N)
    found = ((s_masked >= tau[:, None, None]) & (s_masked != NEG_INF)).sum(2)
    del s_masked
    work = {   # (bytes moved, operations) for this run's inputs
        "submax": (4 * (b * n + b * seen_w + b * w_sub), b * n),
        "kth_largest": (4 * (b * w_sub + b), 2 * 33 * b * w_sub),
        "extract": (4 * (b * n + b * seen_w + b) + 8 * b * w_c,
                    b * n + int((found.clamp(max=K) * found).sum())),
        "pruned_merge": (8 * b * w_c + 4 * b + 8 * b * K, 2 * K * b * w_c),
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
    }
    rows = []
    for kname in tb.KERNELS:
        fn, plain, lib = kernel_fns[kname]
        nbytes, ops = work[kname]
        t_bytes, t_ops = nbytes / MEM_RATE * 1e3, ops / F32_OPS * 1e3
        row = {"name": kname, "route": "cuda", "source": SOURCE,
               "replaces": REPLACES[kname], "launches": launches[kname],
               "max_abs_err": errs.get(kname, 0.0), "ms": time_ms(fn),
               "plain_ms": time_ms(plain), "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": None if lib is None else time_ms(lib)}
        rows.append(row)
        print(f"{kname:13s} {row['ms']} ms  bound {row['bound_ms']} ms "
              f"({row['bound_by']})  plain {row['plain_ms']} ms  library "
              f"{row['library_ms']}  launches/request "
              f"{launches[kname] / len(BATCHES):g}  "
              f"[{card}, B={b}, N={n}, k={K}, L={seen_w}]", flush=True)
    vmem_ms = time_ms(lambda: tb.pruned_merge(cv, ci, K, neg))
    total = time_ms(lambda: tb.blockwise_topk(scores, K, mask_table=mask))

    def masked_topk():
        return torch.topk(metrics.mask_items(scores, mask), K, dim=1)
    print(f"vmem_topk (tau=-inf) {vmem_ms} ms; blockwise_topk total "
          f"{total} ms vs masked torch.topk {time_ms(masked_topk)} ms; "
          f"predict {time_ms(lambda: model.predict(users))} ms "
          f"[{card}, B={b}]")
    for bs in BATCHES:
        u = rng.integers(0, USERS, bs)
        lat = []
        for _ in range(35):
            t0 = time.perf_counter()
            server.recommend(u)
            lat.append((time.perf_counter() - t0) * 1e3)
        lat = np.sort(lat[5:])
        busy = busy_share(lambda: server.recommend(u))
        print(f"recommend B={bs:5d}: p50 {lat[len(lat) // 2]} ms  "
              f"max {lat[-1]} ms  device busy "
              f"{'not measured' if busy is None else busy}  [{card}]")
    shutil.rmtree(root, ignore_errors=True)

    print(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
