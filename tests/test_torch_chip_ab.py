"""The parts of ``chip_ab.py`` (the card's comparison of redesigned kernels
with a parent's) that run without a card: the ctypes argument types it
reads from a launcher's C declaration, the row-order layout it gives the
parent's propagation kernels, and the distribution of survivors per column
block that it prints for extract."""
import ctypes
import importlib.util
import os

import numpy as np
import pytest
import torch

from skrx_torch.ops.kernels import runtime
from skrx_torch.ops.kernels import segsum as ss

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "skrx_torch", "ops", "kernels", "csrc")
P, I = ctypes.c_void_p, ctypes.c_int


def _chip_ab():
    spec = importlib.util.spec_from_file_location(
        "chip_ab", os.path.join(ROOT, "chip_ab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(runtime._SIGNATURES))
def test_argtypes_from_each_declaration_are_the_runtimes(name):
    """chip_ab.py types every launcher of this tree as the package does
    (runtime's list plus the stream)."""
    stem, argtypes = runtime._SIGNATURES[name]
    got = _chip_ab().c_argtypes(os.path.join(CSRC, f"{stem}.cu"), name)
    assert got == argtypes + [P]


# the parent's two-launch propagation, declared over several lines
PARENT_DECLS = """
int skrx_segsum(const float* x, int d, const int* seg_ptr, const int* seg_dst,
                int nseg, const int* src, const float* weight,
                const int* orig, const float* mask, int bf16, float* out,
                float* partial, cudaStream_t stream) {
  return 0;
}

int skrx_segsum_merge(const float* partial, int d, const int* merge_row,
                      const int* merge_ptr, int nmerge, float* out,
                      cudaStream_t stream) {
  return 0;
}
"""


@pytest.mark.parametrize("name,want", [
    ("skrx_segsum", [P, I, P, P, I, P, P, P, P, I, P, P, P]),
    ("skrx_segsum_merge", [P, I, P, P, I, P, P]),
])
def test_argtypes_follow_the_parents_own_declarations(tmp_path, name, want):
    path = tmp_path / "segsum.cu"
    path.write_text(PARENT_DECLS)
    assert _chip_ab().c_argtypes(str(path), name) == want


def test_argtypes_of_a_missing_launcher_raise():
    with pytest.raises(KeyError, match="skrx_segsum_merge"):
        _chip_ab().c_argtypes(os.path.join(CSRC, "segsum.cu"),
                              "skrx_segsum_merge")


def _csr_layout(src, dst, num_nodes, seg_edges):
    """The parent's layout, built independently: edges by destination
    (stable), each row cut into segments of at most seg_edges edges in row
    order, rows of several segments writing partial slots in row order."""
    order = np.argsort(dst, kind="stable")
    deg = np.bincount(dst, minlength=num_nodes)
    ptr, sdst, slot = [0], [], 0
    for r in range(num_nodes):
        n_seg = max(1, -(-deg[r] // seg_edges))
        for i in range(n_seg):
            ptr.append(min(ptr[-1] + seg_edges, ptr[-1] + deg[r] - i * seg_edges)
                       if deg[r] else ptr[-1])
            if n_seg == 1:
                sdst.append(r)
            else:
                sdst.append(-1 - slot)
                slot += 1
    return order, np.array(ptr), np.array(sdst)


@pytest.mark.parametrize("case", ["zipf, both ways", "hubs", "no hub",
                                  "empty"])
def test_row_order_gives_the_parents_csr_layout(case):
    """chip_ab.py runs the parent's kernels on row_order(seg): edges by
    destination in their given order, segments in row order, partial slots
    and merge tables unchanged."""
    from skrx_torch.ops import graph as tg
    rng = np.random.default_rng(8)
    e = ss.SEGMENT_EDGES
    if case == "zipf, both ways":
        users = rng.integers(0, 40, 3000)
        items = 40 + rng.zipf(1.3, 3000) % 60
        src, dst = np.concatenate([users, items]), np.concatenate([items,
                                                                  users])
        n = 100
    elif case == "hubs":
        dst = rng.permutation(np.repeat(np.arange(6), [3 * e + 1, 5, 0, e,
                                                       e + 1, 9 * e]))
        src, n = rng.integers(0, 6, len(dst)), 6
    elif case == "no hub":
        dst, n = rng.integers(0, 50, 900), 50
        src = rng.integers(0, 50, 900)
    else:
        src = dst = np.array([], np.int64)
        n = 5
    g = tg.graph_from_coo(src, dst, rng.random(len(src)), n)
    for seg, (s_, d_) in ((g.fwd, (src, dst)), (g.bwd, (dst, src))):
        got = _chip_ab().row_order(seg)
        order, ptr, sdst = _csr_layout(s_, d_, n, e)
        np.testing.assert_array_equal(got.src.numpy(), s_[order])
        np.testing.assert_array_equal(got.dst.numpy(), d_[order])
        np.testing.assert_array_equal(got.orig.numpy(), order)
        np.testing.assert_array_equal(got.seg_ptr.numpy(), ptr)
        np.testing.assert_array_equal(got.seg_dst.numpy(), sdst)
        assert got.merge_count is seg.merge_count


def _found_case(case: str, rng):
    """(scores, mask table or None, tau, k, block_n) of one extract input."""
    b, n, k, block_n = 5, 1000, 10, 256
    s = rng.standard_normal((b, n)).astype(np.float32)
    mask = rng.integers(-3, n + 3, (b, 40)).astype(np.int32)
    tau = np.quantile(s, 0.97, axis=1).astype(np.float32)
    if case == "tie storm":              # every column equals tau
        s[:] = 0.5
        tau[:] = 0.5
        mask[:, 20:] = n                 # padding, so row 0 keeps full blocks
        mask[0] = n
        block_n = 512                    # more survivors than F
    elif case == "no mask":
        mask = None
    elif case == "-inf rows":
        s[1] = -np.inf
        s[3, 100:] = -np.inf
    elif case == "fully masked row":
        mask = np.full((b, n), n, np.int32)
        mask[2] = np.arange(n)
    elif case == "tau -inf":
        tau[:] = -np.inf
        s[0, :700] = -np.inf
    elif case == "ragged, wide blocks":
        n, block_n, k = 9000, 4096, 50
        s = rng.standard_normal((b, n)).astype(np.float32)
        mask[:, :5] = [0, 4095, 4096, 8999, 9000]
        tau = np.quantile(s, 0.99, axis=1).astype(np.float32)
    elif case == "signed zeros":
        s = np.where(rng.random((b, n)) < 0.5, -0.0, 0.0).astype(np.float32)
        tau[:] = 0.0                     # -0.0 >= +0.0: every column survives
    return s, mask, tau, k, block_n


FOUND_CASES = ["random", "tie storm", "no mask", "-inf rows",
               "fully masked row", "tau -inf", "ragged, wide blocks",
               "signed zeros"]


@pytest.mark.parametrize("case", FOUND_CASES)
def test_found_stats_count_each_blocks_survivors(case):
    """found per (row, block) against a numpy loop over the masked rows:
    finite, unmasked (ids outside [0, N) ignored), >= tau."""
    s, mask, tau, k, block_n = _found_case(case, np.random.default_rng(31))
    b, n = s.shape
    found = []
    for r in range(b):
        row = s[r].copy()
        if mask is not None:
            ids = mask[r][(mask[r] >= 0) & (mask[r] < n)]
            row[ids] = -np.inf
        for j in range(-(-n // block_n)):
            blk = row[j * block_n:(j + 1) * block_n]
            found.append(int(((blk >= tau[r]) & np.isfinite(blk)).sum()))
    found = np.array(found)
    got = _chip_ab().found_stats(
        torch.from_numpy(s), None if mask is None else torch.from_numpy(mask),
        torch.from_numpy(tau), k, block_n)
    cap = _chip_ab().RANK_CAP
    assert got["blocks"] == len(found) and got["max"] == found.max()
    np.testing.assert_allclose(got["mean"], found.mean())
    for key, share in (("share_0", found == 0), ("share_le_32", found <= 32),
                       ("share_ge_k", found >= k),
                       ("share_gt_cap", found > cap)):
        np.testing.assert_allclose(got[key], share.mean())
    if case == "tie storm":
        assert got["max"] == block_n > cap
    with open(os.path.join(CSRC, "topk_blocks.cu")) as f:   # F, as built
        src = f.read()
    assert "constexpr int kRankCap = kExtractThreads;" in src
    assert f"constexpr int kExtractThreads = {cap};" in src


def _variants():
    spec = importlib.util.spec_from_file_location(
        "segsum_merge_variants",
        os.path.join(ROOT, "experiments", "segsum_merge_variants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,gone,added", [
    ("uncapped", "2048 / kThreads", "__launch_bounds__(kThreads)\n"),
    ("acq_rel", "__threadfence();", "atom.add.acq_rel.gpu"),
    ("merge 8", "kMergeFloats = 16", "kMergeFloats = 8"),
])
def test_merge_variants_each_undo_one_choice_of_the_kernel(name, gone,
                                                            added):
    """experiments/segsum_merge_variants.py changes the package's
    segsum.cu in one place a variant (and raises once that text moves)."""
    with open(os.path.join(CSRC, "segsum.cu")) as f:
        text = f.read()
    out = _variants().variant_sources(text)[name]
    assert gone in text and gone not in out and added in out
    assert out.count("segsum_kernel(") == text.count("segsum_kernel(")
    with pytest.raises(ValueError):
        _variants().variant_sources(text.replace(gone, "x"))


def test_merge_variants_need_a_card(monkeypatch):
    mod = _variants()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["segsum_merge_variants.py", "--parent",
                                     "."])
    assert mod.main() == 2


def test_chip_ab_needs_a_card(monkeypatch):
    mod = _chip_ab()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["chip_ab.py", "--parent", "."])
    assert mod.main() == 2
