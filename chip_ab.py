"""Time the port's redesigned kernels against a parent's sources on one card.

Usage, from the root of a checkout, on a machine with a card:

    mkdir -p build/parent
    git archive <parent> skrx_torch/ops/kernels/csrc | tar -x -C build/parent
    python3 chip_ab.py --parent build/parent/skrx_torch/ops/kernels/csrc

``--parent`` names a directory holding the parent's ``segsum.cu``,
``dot_topk.cu`` and ``topk_blocks.cu`` (keep it under ``build/``, which git
ignores). The script builds them with nvcc beside this tree's kernels, the
experimental hot-row design of segsum (``experiments/segsum_hot_rows.cu``)
three times, with clusters of 1, 8 and 16 CTAs (``-DSKRX_SEGSUM_CLUSTER``),
and the experimental radix-select design of kth_largest
(``experiments/kth_radix_select.cu``). Every time is device time per launch
(``chip_smoke.device_ms``: torch.profiler, the kernels' own durations over
50 launches after warm-up), so a kernel shorter than a host launch is not
timed by the host's launch rate. On the synthetic Gowalla-scale data of
``chip_smoke.py`` (seed 2021) it then:

1. segsum on the LightGCN graph (D=64, forward), f32 and bf16 messages,
   with and without a 0.8 dropout mask: each variant's output equal bit
   for bit to the parent's kernel (one fmaf per edge in the same order),
   then the device time of one launch in turns: parent, the variants, the
   variants backwards, parent. The variants: the parent's kernel with eight
   edges' row loads in flight a warp instead of four, and the hot-row
   design with as many hot rows as its cluster holds at D=64 (768, 6,144,
   12,288; :func:`hot_layout`) and once, in its 1-CTA build, with none,
   which times its structure alone;
2. the fused kernels at B=64 (k=50, the evaluator's train table),
   B=1,024 (k=10, the seen table), B=7 (k=10, the seen table) and B=256
   over 1,048,576 random items (k=10, 300 seen ids a row): this tree's
   dot_submax and dot_extract each equal bit for bit to the parent's, then
   timed in turns: parent, new, new, parent;
3. kth_largest on the folded group maxima those dot_submax calls produce
   (B=64 W=1,408 k=50, B=1,024 W=1,408 k=10, B=256 W=4,096 k=10): this
   tree's kernel and the radix-select design equal bit for bit to the
   parent's, then timed in turns: parent, new, radix, radix, new, parent.

Prints one line per measurement with the card's name and power limit, and
writes every number to ``chiprun_out/chip_ab.json``. Exits 2 without CUDA.
"""
import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from chip_smoke import card_line, device_ms
from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.io import synthetic
from skrx_torch.ops.kernels import _build
from skrx_torch.ops.kernels import dot_topk as dt
from skrx_torch.ops.kernels import topk_blocks as tb
from skrx_torch.serve import TopKRecommender

USERS, ITEMS, RATINGS, DIM, SEED = 29_858, 40_981, 1_027_370, 64, 2021
BIG_ITEMS, BIG_B = 1_048_576, 256
CLUSTERS = (1, 8, 16)
HOT_BYTES = 192 * 1024          # csrc/segsum.cu kHotBytes
P, I = ctypes.c_void_p, ctypes.c_int
PARENT_SEGSUM = [P, I, P, P, I, P, P, P, P, I, P, P, P]
NEW_SEGSUM = [P, I, P, P, I, P, P, I, P, P, P, I, P, P, P, P]
EXTRACT = [P, I, I, P, P, I, I, I, P, I, P, I, P, P, P]
SUBMAX = [P, I, I, P, P, I, I, I, P, I, P, P]
KTH = [P, I, I, I, P, P]
# the fused cases whose folded maxima kth_largest is timed on, and its shape
KTH_SHAPES = {"B=64 k=50 (evaluation)": "B=64 W=1408 k=50",
              "B=1024 k=10 (serving)": "B=1024 W=1408 k=10",
              f"B={BIG_B} N={BIG_ITEMS} k=10": f"B={BIG_B} W=4096 k=10"}


def hot_layout(src: np.ndarray, num_src_nodes: int, hot_rows: int):
    """(enc, hot) int32 for the experimental kernel, for edges whose source
    rows are ``src`` in the order the kernel walks them: ``hot`` lists the
    ``hot_rows`` source rows of most edges, most first (ties to the lower
    id; rows without edges left out), and ``enc`` gives each edge's source
    as -(slot + 1) of a hot row, else as the row."""
    src = np.asarray(src, np.int64)
    out_deg = np.bincount(src, minlength=num_src_nodes)
    n_hot = min(int(hot_rows), int((out_deg > 0).sum()))
    hot = np.argsort(-out_deg, kind="stable")[:n_hot]
    slot = np.full(num_src_nodes, -1, np.int64)
    slot[hot] = np.arange(n_hot)
    enc = np.where(slot[src] >= 0, -1 - slot[src], src)
    return enc.astype(np.int32), hot.astype(np.int32)


def build(jobs: dict, out_dir: str) -> dict:
    """{name: (source, extra nvcc flags)} -> {name: loaded library}, one
    nvcc each, all started together."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (src, flags) in jobs.items():
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def c_fn(lib, name: str, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def ptr(t):
    return None if t is None else t.data_ptr()


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def checked(fn):
    def call(*args):
        err = fn(*args, stream())
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return call


def in_turns(fns: dict, order) -> dict:
    """{name: [ms of each turn]} timing fns in the given order of names."""
    times = {name: [] for name in fns}
    for name in order:
        times[name].append(device_ms(fns[name]))
    return times


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="directory with the parent's segsum.cu, dot_topk.cu "
                    "and topk_blocks.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    hot_src = os.path.join(here, "experiments", "segsum_hot_rows.cu")
    radix_src = os.path.join(here, "experiments", "kth_radix_select.cu")
    out_dir = os.path.join(here, "build", "chip_ab")
    os.makedirs(out_dir, exist_ok=True)
    # the parent's segsum with eight edges' row loads in flight a warp
    # instead of four: its edge loop's unroll pragma changed, nothing else
    with open(os.path.join(args.parent, "segsum.cu")) as f:
        text = f.read()
    edge_loop = "#pragma unroll 4\n    for (int i = 0; i < n; ++i) {"
    if text.count(edge_loop) != 1:
        raise RuntimeError("the parent's segsum.cu has no edge loop to unroll")
    unroll8 = os.path.join(out_dir, "segsum_unroll8.cu")
    with open(unroll8, "w") as f:
        f.write(text.replace(edge_loop, edge_loop.replace("4", "8", 1)))
    jobs = {"parent_segsum": (os.path.join(args.parent, "segsum.cu"), []),
            "parent_segsum_unroll8": (unroll8, []),
            "parent_dot_topk": (os.path.join(args.parent, "dot_topk.cu"), []),
            "parent_topk": (os.path.join(args.parent, "topk_blocks.cu"), []),
            "kth_radix": (radix_src, [])}
    for c in CLUSTERS:
        jobs[f"segsum_c{c}"] = (hot_src, [f"-DSKRX_SEGSUM_CLUSTER={c}"])
    t0 = time.perf_counter()
    libs = build(jobs, out_dir)
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    results = {"card": card}

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

    # ---------------------------------------------------------- segsum
    fwd = gcn.graph.fwd
    src = fwd.src.cpu().numpy()
    x = torch.cat([gcn.user_emb, gcn.item_emb]).detach().contiguous()
    keep = torch.rand(fwd.src.shape[0], device=dev,
                      generator=torch.Generator(dev).manual_seed(SEED)) < 0.8
    drop = keep.float() / 0.8
    # (cluster size, hot rows) of each variant: as many as its cluster holds
    # at D=64, and the 1-CTA build with none (its structure alone)
    variants = {f"c{c}": (c, c * (HOT_BYTES // (4 * DIM))) for c in CLUSTERS}
    variants["c1 no hot"] = (1, 0)
    layouts = {}
    for name, (c, rows) in variants.items():
        enc, hot = hot_layout(src, fwd.num_src_nodes, rows)
        layouts[name] = (torch.from_numpy(enc).to(dev),
                         torch.from_numpy(hot).to(dev))
        share = float((enc < 0).mean())
        results[f"segsum {name} hot"] = {"rows": rows, "edge_share": share}
        print(f"{name}: {rows} hot rows carry {share} of the edges",
              flush=True)
    out = torch.empty((fwd.num_nodes, DIM), device=dev)
    partial = torch.empty((fwd.num_partials, DIM), device=dev)
    parent = checked(c_fn(libs["parent_segsum"], "skrx_segsum", PARENT_SEGSUM))
    parent8 = checked(c_fn(libs["parent_segsum_unroll8"], "skrx_segsum",
                           PARENT_SEGSUM))
    queue = torch.zeros(1, dtype=torch.int32, device=dev)
    variant = {name: checked(c_fn(libs[f"segsum_c{c}"], "skrx_segsum",
                                  NEW_SEGSUM))
               for name, (c, _) in variants.items()}
    nseg = fwd.seg_dst.shape[0]
    for msg, bf16 in (("f32", 0), ("bf16", 1)):
        for tag, m in (("no mask", None), ("dropout 0.8", drop)):
            def run_parent(fn=parent):
                fn(ptr(x), DIM, ptr(fwd.seg_ptr), ptr(fwd.seg_dst), nseg,
                   ptr(fwd.src), ptr(fwd.weight), ptr(fwd.orig), ptr(m), bf16,
                   ptr(out), ptr(partial))

            def run_variant(name):
                enc, hot = layouts[name]
                return lambda: variant[name](
                    ptr(x), DIM, ptr(fwd.seg_ptr), ptr(fwd.seg_dst), nseg,
                    ptr(enc), ptr(hot), hot.shape[0], ptr(fwd.weight),
                    ptr(fwd.orig), ptr(m), bf16, ptr(out), ptr(partial),
                    ptr(queue))
            fns = {"parent": run_parent,
                   "parent unroll 8": lambda: run_parent(parent8)}
            fns.update({name: run_variant(name) for name in variants})
            out.zero_()                 # rows of several segments stay 0
            run_parent()
            ref = (out.clone(), partial.clone())
            for name in ["parent unroll 8", *variants]:
                out.zero_()
                partial.zero_()
                fns[name]()
                torch.cuda.synchronize()
                if not (torch.equal(out, ref[0])
                        and torch.equal(partial, ref[1])):
                    raise AssertionError(f"segsum {name} {msg} {tag}: not "
                                         "equal to the parent's kernel")
            names = ["parent", "parent unroll 8", *variants]
            times = in_turns(fns, names + names[::-1])
            results[f"segsum {msg} {tag}"] = times
            print(f"segsum {msg} {tag} (== parent bit for bit): " + ", ".join(
                f"{k} {np.mean(v)} ms {v}" for k, v in times.items())
                + f"  [{card}]", flush=True)

    # ------------------------------- dot_submax, dot_extract, kth_largest
    new_lib = _build.load("dot_topk")
    fused = {"dot_submax": {"parent": c_fn(libs["parent_dot_topk"],
                                           "skrx_dot_submax", SUBMAX),
                            "new": c_fn(new_lib, "skrx_dot_submax", SUBMAX)},
             "dot_extract": {"parent": c_fn(libs["parent_dot_topk"],
                                            "skrx_dot_extract", EXTRACT),
                             "new": c_fn(new_lib, "skrx_dot_extract",
                                         EXTRACT)}}
    kth = {"parent": c_fn(libs["parent_topk"], "skrx_kth_largest", KTH),
           "new": c_fn(_build.load("topk_blocks"), "skrx_kth_largest", KTH),
           "radix": c_fn(libs["kth_radix"], "skrx_kth_largest", KTH)}
    ev = bpr.evaluator
    rng = np.random.default_rng(SEED)
    test_users = np.fromiter(ev.user_pos_test, np.int64)
    packed = dt.pack_items(bpr.item_emb, bpr.item_bias)
    seen = TopKRecommender(bpr, k=10)._seen
    gen = torch.Generator(dev).manual_seed(SEED)
    big = dt.pack_items(torch.randn((BIG_ITEMS, DIM), device=dev, generator=gen),
                        torch.randn((BIG_ITEMS,), device=dev, generator=gen))
    big_uv = torch.randn((BIG_B, DIM), device=dev, generator=gen)
    big_seen = torch.randint(0, BIG_ITEMS, (BIG_B, 300), device=dev,
                             generator=gen, dtype=torch.int32)
    u64 = rng.choice(test_users, 64, replace=False)
    u1k = rng.integers(0, USERS, 1024)
    cases = {
        "B=64 k=50 (evaluation)": (
            bpr.user_emb.detach()[torch.as_tensor(u64, device=dev)], packed,
            torch.from_numpy(ev._tables_for(u64, ITEMS)[0]).to(dev), 50),
        "B=1024 k=10 (serving)": (
            bpr.user_emb.detach()[torch.as_tensor(u1k, device=dev)], packed,
            seen[torch.as_tensor(u1k, device=dev)], 10),
        "B=7 k=10 (serving)": (
            bpr.user_emb.detach()[torch.as_tensor(u1k[:7], device=dev)],
            packed, seen[torch.as_tensor(u1k[:7], device=dev)], 10),
        f"B={BIG_B} N={BIG_ITEMS} k=10": (big_uv, big, big_seen, 10),
    }

    def report(kname: str, tag: str, times: dict) -> None:
        results[f"{kname} {tag}"] = times
        print(f"{kname} {tag} (== parent bit for bit): " + ", ".join(
            f"{k_} {np.mean(v)} ms {v}" for k_, v in times.items())
            + f"  [{card}]", flush=True)

    for tag, (uv, pk, mask, k) in cases.items():
        uv = uv.contiguous()
        mask = mask.contiguous()
        b = uv.shape[0]
        uvp = dt._padded_uv(uv, pk)
        head = (ptr(uvp), b, pk.table.shape[0], ptr(pk.table), ptr(pk.bias),
                pk.n, pk.table.shape[1], pk.block_n, ptr(mask), mask.shape[1])
        n_blocks = pk.table.shape[1] // pk.block_n
        # dot_submax
        bms = {name: torch.empty((b, n_blocks * 128), device=dev)
               for name in ("parent", "new")}
        fns = {name: (lambda fn=checked(fn), out=bms[name]:
                      fn(*head, ptr(out)))
               for name, fn in fused["dot_submax"].items()}
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
        if not torch.equal(bms["parent"].view(torch.int32),
                           bms["new"].view(torch.int32)):
            raise AssertionError(f"dot_submax {tag}: not equal to the "
                                 "parent's kernel")
        report("dot_submax", tag, in_turns(fns, ["parent", "new", "new",
                                                 "parent"]))
        # kth_largest on the folded maxima of this call
        bmf = tb.fold_submaxes(bms["new"], k).contiguous()
        taus = {name: torch.empty((b,), device=dev) for name in kth}
        fns = {name: (lambda fn=checked(fn), out=taus[name]:
                      fn(ptr(bmf), b, bmf.shape[1], k, ptr(out)))
               for name, fn in kth.items()}
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
        for name in ("new", "radix"):
            if not torch.equal(taus["parent"].view(torch.int32),
                               taus[name].view(torch.int32)):
                raise AssertionError(f"kth_largest {name} {tag}: not equal to "
                                     "the parent's kernel")
        if tag in KTH_SHAPES:
            report("kth_largest", KTH_SHAPES[tag], in_turns(
                fns, ["parent", "new", "radix", "radix", "new", "parent"]))
        # dot_extract
        tau = taus["new"]
        w = n_blocks * k
        outs = {name: (torch.empty((b, w), device=dev),
                       torch.empty((b, w), device=dev, dtype=torch.int32))
                for name in ("parent", "new")}
        fns = {name: (lambda fn=checked(fn), out=outs[name]:
                      fn(*head, ptr(tau), k, ptr(out[0]), ptr(out[1])))
               for name, fn in fused["dot_extract"].items()}
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
        if not (torch.equal(outs["parent"][0], outs["new"][0])
                and torch.equal(outs["parent"][1], outs["new"][1])):
            raise AssertionError(f"dot_extract {tag}: not equal to the "
                                 "parent's kernel")
        report("dot_extract", tag, in_turns(fns, ["parent", "new", "new",
                                                  "parent"]))

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", "chip_ab.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({"ok": True, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
