"""Designs of kernel #8 (direct_rank) timed against the package's kernel on
one card.

Usage, from the root of a checkout, on a machine with a card:

    python3 experiments/direct_rank_designs.py

Builds ``experiments/direct_rank_designs.cu`` with nvcc: the package's
kernel at a cluster size given (1, 2, 4, 8; "cl1" .. "cl8"), design (a)
("warp": a warp per 4 found probes, the row's columns split over lanes and
a cluster), design (c) ("loop": the parent's one thread a probe over the
whole row, with only the mask bitmap and the list of found probes), design
(b) as first built, its loads issued first ("sort": a bitonic sort of
the found probes' keys, __match_any_sync, the leader pulling the cluster's
histograms), the
workbench (a copy of the package's kernel with its choices as switches:
1,024 threads, keys not skewed, __match_any_sync) and the floor (the same
grid writing only k), all but the cluster sizes at the package's cluster
size.
On the inputs of ``chip_ab.py``'s phase 7 (``chip_ab.direct_rank_cases``:
evaluation batches at MovieLens-1M scale, T cut to 128, MovieLens-100k
scale, N=12,799, and B=7 rows of N=51,000 with one probe), each design's
counts must equal the package kernel's; then all are timed in turns (each
name, then the names in reverse) by device time per call
(``chip_smoke.device_ms``), and one marked launch of the workbench as the
package is gives the cycles of each phase. Prints one line per case with
the card's name,
power limit and SM clock, writes ``chiprun_out/direct_rank_designs.json``;
exits 2 without CUDA.
"""
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
from skrx_torch.ops.kernels import _build  # noqa: E402
from skrx_torch.ops.kernels import topk_blocks as tb  # noqa: E402

SOURCE = os.path.join(ROOT, "experiments", "direct_rank_designs.cu")
CLUSTERS = (1, 2, 4, 8)
DESIGNS = ("warp", "loop")
# workbench switches: (threads, skewed keys, match); the first is the
# package's kernel as copied
BENCH = ((512, 1, 0), (512, 0, 0), (512, 1, 1), (1024, 1, 0))
PHASES = ("mask bitmap", "found listed", "probes placed", "columns counted",
          "histograms met", "prefix sum and writes")


def package_cluster(b: int, n: int, sms: int) -> int:
    """The package's cluster size (``direct_rank_cluster``)."""
    return max(1, min(sms // max(b, 1), n // 1024, 8))


def phases(bench, scores, mask, probes, k: int, cl: int, tag: str,
           card: str) -> dict:
    """One marked launch of the workbench as the package is (512 threads,
    skewed keys, no match) at cluster size cl: per phase the mean and
    largest cycles a CTA spent (clock64), the found probes a CTA, and the
    span from the first CTA's start to the last one's end and a CTA's mean
    life (globaltimer, ns)."""
    b, n = scores.shape
    t = probes.shape[1]
    ctas = b * cl * -(-t // 512)
    marks = torch.zeros((ctas, 10), dtype=torch.int64, device=scores.device)
    out = torch.empty((b, t), dtype=torch.int32, device=scores.device)
    bench(ab.ptr(scores), b, n, ab.ptr(mask), mask.shape[1], ab.ptr(probes),
          t, k, ab.ptr(out), cl, 512, 1, 0, ab.ptr(marks))
    m = marks.cpu().double()
    d = m[:, 1:7] - m[:, 0:6]
    res = {name: [float(d[:, i].mean()), float(d[:, i].max())]
           for i, name in enumerate(PHASES)}
    res["found a CTA"] = float(m[:, 9].mean())
    res["span ns"] = float(m[:, 8].max() - m[:, 7].min())
    res["CTA ns, mean"] = float((m[:, 8] - m[:, 7]).mean())
    print(f"{tag} phases of the package's kernel (the workbench's copy, "
          f"cl={cl}), cycles a CTA (mean, max): " + ", ".join(
              f"{k_} {v}" for k_, v in res.items()) + f"  [{card}]",
          flush=True)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("direct_rank_designs: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    card = card_line()
    print(f"card: {card}", flush=True)
    libs, logs = ab.build({"designs": SOURCE},
                          os.path.join(ROOT, "build", "direct_rank_designs"))
    for line in logs["designs"].splitlines():
        if "registers" in line:
            print(f"  ptxas: {line.strip()}")
    _build.load("rank_counts")
    lib = libs["designs"]
    with_cl = ab.c_fn(lib, SOURCE, "skrx_direct_rank_cl")
    fns = {name: ab.c_fn(lib, SOURCE, f"skrx_direct_rank_{name}")
           for name in DESIGNS}
    sort = ab.c_fn(lib, SOURCE, "skrx_direct_rank_sort")
    bench = ab.c_fn(lib, SOURCE, "skrx_direct_rank_workbench")
    floor = ab.c_fn(lib, SOURCE, "skrx_direct_rank_floor")
    root = os.path.join(ROOT, "build", "direct_rank_designs_data")
    shutil.rmtree(root, ignore_errors=True)
    results = {"card": card}
    for tag, scores, mask, probes, k in ab.direct_rank_cases(root, dev):
        b, n = scores.shape
        t, width = probes.shape[1], mask.shape[1]
        cl = package_cluster(b, n, sms)
        ref = tb.direct_rank(scores, probes, k, mask)
        switches = {f"bench_{th}_skew{sk}_match{mt}": (th, sk, mt)
                    for th, sk, mt in BENCH}
        names = ([f"cl{c}" for c in CLUSTERS] + list(DESIGNS) + ["sort"]
                 + list(switches))
        outs = {name: torch.empty_like(ref) for name in names}
        floor_out = torch.empty_like(ref)

        def runner(name):
            args = (ab.ptr(scores), b, n, ab.ptr(mask), width,
                    ab.ptr(probes), t, k, ab.ptr(outs[name]))
            if name.startswith("cl"):
                return lambda: with_cl(*args, int(name[2:]))
            if name == "sort":
                return lambda: sort(*args, cl)
            if name in switches:
                return lambda: bench(*args, cl, *switches[name], None)
            return lambda: fns[name](*args)
        calls = {"package": lambda: tb.direct_rank(scores, probes, k, mask)}
        calls.update({name: runner(name) for name in names})
        calls["floor"] = lambda: floor(b, t, k, ab.ptr(floor_out),
                                       cl if cl > 1 else 0)
        for name in names:
            calls[name]()
        torch.cuda.synchronize()
        for name in names:
            if not torch.equal(outs[name], ref):
                raise AssertionError(f"{name} at {tag}: not equal to the "
                                     "package's kernel")
        order = list(calls)
        times = ab.in_turns(calls, order + order[::-1])
        found = int(ab.found_probes(scores, mask, probes).sum())
        results[tag] = {"cluster": cl, "times": times,
                        "phases": phases(bench, scores, mask, probes, k, cl,
                                         tag, card)}
        print(f"{tag} (the package's cluster size {cl}; each == the "
              f"package's kernel; found probes {found}): " + ", ".join(
                  f"{k_} {np.mean(v)} ms {v}" for k_, v in times.items())
              + f"  [{card}; SM clock after the turns {ab.sm_clock()}]",
              flush=True)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "direct_rank_designs.json"),
              "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
