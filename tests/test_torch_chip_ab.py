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


@pytest.mark.parametrize("source,has_merge", [("parent", True),
                                               ("this tree", False)])
def test_phase_1_runs_for_a_parent_with_the_two_launch_propagation(
        tmp_path, source, has_merge):
    """chip_ab.py runs phase 1 when the parent's segsum.cu declares
    skrx_segsum_merge (the two-launch propagation), as PARENT_DECLS does
    and this tree's segsum.cu does not."""
    path = tmp_path / "segsum.cu"
    path.write_text(PARENT_DECLS)
    if source == "this tree":
        path = os.path.join(CSRC, "segsum.cu")
    decls = _chip_ab().c_declarations(str(path))
    assert "skrx_segsum" in decls
    assert ("skrx_segsum_merge" in decls) == has_merge


@pytest.mark.parametrize("case", ["random", "tau -inf", "repeated pairs",
                                  "NaN", "wide"])
def test_merge_survivors_count_each_rows_survivors(case):
    """The survivors pruned_merge lists a row, against a numpy loop: v >=
    tau and finite from below (NaN fails), repeated pairs each time."""
    rng = np.random.default_rng(12)
    b, w, k = 6, 110, 10
    vals = rng.standard_normal((b, w)).astype(np.float32)
    tau = np.quantile(vals, 0.85, axis=1).astype(np.float32)
    vals[0, :30] = -np.inf
    if case == "tau -inf":
        tau[:] = -np.inf
    elif case == "repeated pairs":
        vals[:, :20] = 9.0
    elif case == "NaN":
        vals[:, ::3] = np.nan
    elif case == "wide":
        w = 600
        vals = rng.standard_normal((b, w)).astype(np.float32)
        tau[:] = -1.0
    found = np.array([int(((row >= t) & (row != -np.inf)).sum())
                      for row, t in zip(vals, tau)])
    mod = _chip_ab()
    got = mod.merge_survivors(torch.from_numpy(vals), torch.from_numpy(tau),
                              k)
    assert got["rows"] == b and got["max"] == found.max()
    np.testing.assert_allclose(got["mean"], found.mean())
    for key, share in (("share_le_32", found <= 32),
                       ("share_ge_k", found >= k),
                       ("share_gt_cap", found > mod.MERGE_CAP)):
        np.testing.assert_allclose(got[key], share.mean())
    with open(os.path.join(CSRC, "topk_blocks.cu")) as f:   # F, as built
        src = f.read()
    assert "constexpr int kMergeCap = kMergeThreads;" in src
    assert f"constexpr int kMergeThreads = {mod.MERGE_CAP};" in src


@pytest.mark.parametrize("chunk", [256, 300])
def test_chunk_merge_input_is_the_evaluators_second_merge(tmp_path,
                                                          monkeypatch,
                                                          chunk):
    """chunk_merge_input builds the chunked evaluate()'s second merge: the
    running best after the first chunk beside the second chunk's masked
    top-k, so merging it gives the masked top-k of the first two chunks;
    the first half is sorted, with (-inf, N + 1) only where a row has
    fewer than k items."""
    from skrx_torch import ModelRegistry, RunConfig
    from skrx_torch.io import synthetic
    from skrx_torch.ops import metrics
    from skrx_torch.ops.kernels import topk_blocks as tb
    monkeypatch.chdir(tmp_path)
    data = synthetic.make_dataset_dir(str(tmp_path), num_users=40,
                                      num_items=700, num_ratings=2500, seed=3)
    reg = ModelRegistry()
    reg.load_skrx_model("BPRMF")
    cls, _ = reg.get_model("BPRMF")
    m = cls(RunConfig(data_dir=data, seed=3), dict(n_dim=8, epochs=1),
            device="cpu")
    users = np.arange(7)
    n, k = m.num_items, 10
    train_t = torch.from_numpy(m.evaluator._tables_for(users, n)[0])
    vals, ids = _chip_ab().chunk_merge_input(m, users, train_t, k, n, chunk)
    assert vals.shape == ids.shape == (7, 2 * k)
    got = tb.vmem_topk(vals, ids, k)
    scores = m.predict_chunk(users, 0, 2 * chunk)
    mask = torch.where(train_t < 2 * chunk, train_t, 2 * chunk)
    ref = tb.pruned_merge_plain(
        metrics.mask_items(scores, mask),
        torch.arange(2 * chunk, dtype=torch.int32).expand(7, -1).contiguous(),
        k, torch.full((7,), float("-inf")))
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    best = vals[:, :k]
    assert (best == torch.sort(best, 1, descending=True)[0]).all()


@pytest.mark.parametrize("case", ["random", "empty slots", "repeats",
                                  "signed zeros", "NaN", "two tiles"])
def test_rank_segments_count_runs_of_equal_keys(case):
    """The segments rank_count counts over, against a numpy loop: a new
    segment at every tile start and wherever the (value, id) pair changes,
    -0.0 and +0.0 of one id one key, every NaN candidate one key whatever
    its id."""
    rng = np.random.default_rng(14)
    b, w, tile = 3, 300, 2048
    vals = rng.standard_normal((b, w)).astype(np.float32)
    ids = rng.integers(0, 1000, (b, w)).astype(np.int32)
    if case == "empty slots":
        vals[:, np.arange(w) % 50 >= 5] = -np.inf
        ids[:, np.arange(w) % 50 >= 5] = 2 ** 30 - 1
    elif case == "repeats":
        at = np.repeat(np.arange(w), 7)[:w]
        vals, ids = vals[:, at], ids[:, at]
    elif case == "signed zeros":
        vals[:] = np.where(np.arange(w) % 2, 0.0, -0.0)
        ids[:] = 4
    elif case == "NaN":
        vals[:, 100:200] = np.nan
    elif case == "two tiles":
        w, tile = 300, 128
        vals[:] = 1.0
        ids[:] = 2
    want = []
    for r in range(b):
        pairs = [("nan", 0) if np.isnan(x) else (0.0 if x == 0 else float(x),
                                                 int(j))
                 for x, j in zip(vals[r], ids[r])]
        want.append(sum(e % tile == 0 or pairs[e] != pairs[e - 1]
                        for e in range(w)))
    smoke = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(smoke)
    smoke.loader.exec_module(mod)
    got = mod.rank_segments(torch.from_numpy(vals), torch.from_numpy(ids),
                            tile)
    assert got.tolist() == want
    with open(os.path.join(CSRC, "rank_counts.cu")) as f:   # the tile, built
        assert "constexpr int kKeyTile = 2048;" in f.read()


def test_rank_count_cases_are_masked_topk_ranks_inputs(tmp_path,
                                                      monkeypatch):
    """rank_count_cases gives rank_count what masked_topk_ranks gives it in
    an evaluation batch (so the counts are its ranks wherever the test item
    is valid), and the last case the first one's candidates with the empty
    slots' ids made distinct: no two adjacent keys equal."""
    from skrx_torch import ModelRegistry, RunConfig
    from skrx_torch.io import synthetic
    from skrx_torch.ops.kernels import topk_blocks as tb
    monkeypatch.chdir(tmp_path)
    data = synthetic.make_dataset_dir(str(tmp_path), num_users=30,
                                      num_items=6500, num_ratings=7000,
                                      seed=4)
    reg = ModelRegistry()
    reg.load_skrx_model("BPRMF")
    cls, _ = reg.get_model("BPRMF")
    m = cls(RunConfig(data_dir=data, seed=4), dict(n_dim=8, epochs=1),
            device="cpu")
    users = np.fromiter(m.evaluator.user_pos_test, np.int64)[:6]
    cases = _chip_ab().rank_count_cases(m, [users])
    assert [c[0] for c in cases] == ["", ", no repeated keys"]
    _, cand_v, cand_i, s_t, probes = cases[0]
    tr, te, _ = (torch.from_numpy(x)
                 for x in m.evaluator._tables_for(users, m.num_items))
    want = tb.masked_topk_ranks(m.predict(users), 50, te, tr)
    got = tb.rank_count(cand_v, cand_i, s_t, probes)
    assert torch.equal(torch.where(want < 50, got, want), want)
    _, v2, i2, s2, p2 = cases[1]
    assert v2 is cand_v and s2 is s_t and p2 is probes
    assert torch.equal(i2 == cand_i, cand_i != tb.SENTINEL)
    key = tb.rank_key(v2, i2)
    assert bool((key[:, 1:] != key[:, :-1]).all())


@pytest.mark.parametrize("case", ["equal", "+0 vs -0", "-0 vs +0",
                                  "values differ"])
def test_sign_flips_name_the_signed_zeros_that_differ(case):
    """sign_flips lists the (row, column) where two f32 tensors are equal
    as floats but not as int32 views, and nothing else."""
    ref = torch.tensor([[1.0, 0.0, -0.0], [float("-inf"), 0.5, 0.0]])
    got = ref.clone()
    want = []
    if case == "+0 vs -0":
        got[0, 1], want = -0.0, [[0, 1]]
    elif case == "-0 vs +0":
        got[0, 2], got[1, 2], want = 0.0, -0.0, [[0, 2], [1, 2]]
    elif case == "values differ":
        got[1, 1] = 0.25
    assert _chip_ab().sign_flips(got, ref) == want


def test_lookup_cases_are_fused_evaluations_inputs(tmp_path, monkeypatch):
    """lookup_cases gives rank_lookup_count what dot_topk_ranks gives it in
    a fused evaluation batch (so its ranks are the fused route's wherever
    the item is found); then the candidates with no -inf lane, every empty
    slot below its row's smallest value (found probes keep their ranks);
    then a NaN at a found probe's id in each row (that probe not found,
    rank 0)."""
    from skrx_torch import ModelRegistry, RunConfig
    from skrx_torch.io import synthetic
    from skrx_torch.ops.kernels import dot_topk as dt
    from skrx_torch.ops.kernels import topk_blocks as tb
    monkeypatch.chdir(tmp_path)
    # 10 column blocks, so that a block's k = 50 slots are mostly empty
    data = synthetic.make_dataset_dir(str(tmp_path), num_users=30,
                                      num_items=40_000, num_ratings=41_000,
                                      seed=4)
    reg = ModelRegistry()
    reg.load_skrx_model("BPRMF")
    cls, _ = reg.get_model("BPRMF")
    m = cls(RunConfig(data_dir=data, seed=4), dict(n_dim=8, epochs=1),
            device="cpu")
    users = np.fromiter(m.evaluator.user_pos_test, np.int64)[:6]
    cases = _chip_ab().lookup_cases(m, users)
    assert [c[0] for c in cases] == ["", ", no -inf lane", ", NaN row"]
    _, cand_v, cand_i, probes = cases[0]
    tr, te, _ = (torch.from_numpy(x)
                 for x in m.evaluator._tables_for(users, m.num_items))
    assert torch.equal(probes, te)
    ranks, found = tb.rank_lookup_count(cand_v, cand_i, probes)
    u_all, i_all = m._chunk_embeddings()
    want = dt.dot_topk_ranks(u_all.detach()[torch.from_numpy(users)], None,
                             None, 50, te, tr, packed=dt.pack_items(
                                 i_all.detach(), m._chunk_bias().detach()))
    assert torch.equal(torch.where(found, ranks, 50), want)
    assert bool(found.any()) and bool((cand_v == float("-inf")).any())
    _, v2, i2, p2 = cases[1]
    assert i2 is cand_i and p2 is probes
    assert bool(torch.isfinite(v2).all())
    filled = cand_v == float("-inf")
    assert bool((v2[filled] < torch.where(filled, float("inf"), cand_v).amin(
        1, keepdim=True).expand_as(v2)[filled]).all())
    key = tb.rank_key(v2, i2)
    assert bool((key[:, 1:] != key[:, :-1]).all())
    r2, f2 = tb.rank_lookup_count(v2, i2, p2)
    assert torch.equal(f2, found) and torch.equal(r2[found], ranks[found])
    _, v3, i3, p3 = cases[2]
    nan = v3.isnan()                  # one a row, at the first probe's id
    assert torch.equal(nan.sum(1), torch.ones(len(users), dtype=torch.long))
    assert bool((cand_v[nan] == float("-inf")).all())
    assert torch.equal(p3[:, 1:], probes[:, 1:])
    assert torch.equal(p3[:, 0], i3[nan])
    assert bool(((cand_i == p3[:, :1]) & torch.isfinite(cand_v)).any(1).all())
    r3, f3 = tb.rank_lookup_count(v3, i3, p3)
    assert not bool(f3[:, 0].any()) and not bool(r3[:, 0].any())


def test_rank_count_designs_need_a_card(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "rank_count_designs",
        os.path.join(ROOT, "experiments", "rank_count_designs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main() == 2
    with open(os.path.join(ROOT, "experiments",
                           "rank_count_designs.cu")) as f:
        src = f.read()
    for name in mod.DESIGNS:           # each launcher typed from its source
        assert _chip_ab().c_argtypes(
            mod.SOURCE, f"skrx_rank_count_{name}") == \
            runtime._SIGNATURES["skrx_rank_count"][1] + [P]
        assert f"int skrx_rank_count_{name}(" in src


def test_submax_variants_need_a_card(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "submax_variants",
        os.path.join(ROOT, "experiments", "submax_variants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main() == 2
    with open(mod.SOURCE) as f:
        src = f.read()
    for name in mod.VARIANTS:          # each launcher typed from its source
        assert _chip_ab().c_argtypes(mod.SOURCE, f"skrx_submax_{name}") == \
            runtime._SIGNATURES["skrx_submax"][1] + [P]
        assert f"int skrx_submax_{name}(" in src


@pytest.mark.parametrize("case", ["evaluator tables", "no probe found",
                                  "NaN and out of range"])
def test_found_probes_count_what_direct_rank_counts(case):
    """found_probes gives, per row, the probes that direct_rank counts for
    (id in [0, N), not in the mask row, finite score): those whose rank
    is not k in a row where every such probe ranks below k."""
    rng = np.random.default_rng(7)
    b, n, k = 5, 300, 1000
    s = rng.standard_normal((b, n)).astype(np.float32)
    mask = rng.integers(-2, n + 2, (b, 40)).astype(np.int32)
    probes = rng.integers(-3, n + 3, (b, 30)).astype(np.int32)
    if case == "no probe found":
        probes[:] = n
    elif case == "NaN and out of range":
        s[:, ::4] = np.nan
        s[1, 1::4] = np.inf
        probes[:, :5] = (0, 4, -1, n, 1)
    want = [sum(0 <= t < n and t not in set(mask[r]) and np.isfinite(s[r, t])
                for t in probes[r]) for r in range(b)]
    got = _chip_ab().found_probes(*(torch.from_numpy(x)
                                    for x in (s, mask, probes)))
    assert got.tolist() == want
    from skrx_torch.ops.kernels import topk_blocks as tb
    ranks = tb.direct_rank(*(torch.from_numpy(x) for x in (s, probes)), k,
                           torch.from_numpy(mask))
    assert (ranks < k).sum(1).tolist() == want


def test_direct_rank_cases_are_evaluation_batches(tmp_path, monkeypatch):
    """direct_rank_cases gives each dataset's evaluation batch as the
    evaluator pads it (train table as the mask, test table as the probes),
    the first one again with T cut to 128, then 7 rows of 51,000 columns
    with one probe at k=200."""
    ab = _chip_ab()
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(ab, "DIRECT_DATA", (("A", 80, 700, 9000),
                                            ("B", 70, 300, 4000)))
    cases = ab.direct_rank_cases(str(tmp_path), "cpu")
    assert len(cases) == 4
    for tag, scores, mask, probes, k in cases[:3]:
        assert scores.shape[0] == mask.shape[0] == probes.shape[0] == 64
        assert f"N={scores.shape[1]} L={mask.shape[1]} T={probes.shape[1]}" \
            in tag and k == 50
        n = scores.shape[1]
        assert bool(((mask >= 0) & (mask <= n)).all())
        assert bool(((probes >= 0) & (probes <= n)).all())
        # each row's train and test items apart, padding (n) at the end
        for r in range(64):
            tr, te = set(mask[r].tolist()) - {n}, set(probes[r].tolist()) - {n}
            assert te and not (tr & te)
    assert cases[0][0].startswith("A B=64 N=700")
    assert torch.equal(cases[1][3], cases[0][3][:, :128])
    assert cases[1][0].endswith(f"T={cases[1][3].shape[1]} k=50")
    assert cases[2][0].startswith("B B=64 N=300")
    tag, scores, mask, probes, k = cases[3]
    assert (tuple(scores.shape), tuple(mask.shape), tuple(probes.shape), k) \
        == ((7, 51_000), (7, 300), (7, 1), 200)


def test_direct_rank_designs_need_a_card(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "direct_rank_designs",
        os.path.join(ROOT, "experiments", "direct_rank_designs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main() == 2
    with open(mod.SOURCE) as f:
        src = f.read()
    want = runtime._SIGNATURES["skrx_direct_rank"][1]
    for name in mod.DESIGNS:           # each launcher typed from its source
        assert _chip_ab().c_argtypes(
            mod.SOURCE, f"skrx_direct_rank_{name}") == want + [P]
        assert f"int skrx_direct_rank_{name}(" in src
    assert _chip_ab().c_argtypes(mod.SOURCE, "skrx_direct_rank_cl") == \
        want + [I, P]


def _dedup_designs():
    spec = importlib.util.spec_from_file_location(
        "dedup_rows_designs",
        os.path.join(ROOT, "experiments", "dedup_rows_designs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dedup_rows_designs_need_a_card(monkeypatch):
    mod = _dedup_designs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main() == 2
    assert mod.DESIGNS["segment_reduce"] is mod.optim.dedup_rows


@pytest.mark.parametrize("shape", [(64, 8), (64,), (1, 3), (300, 4)])
def test_replaced_dedup_design_sums_as_the_package(shape):
    """The doubling design timed against the package's lists the same
    distinct rows and the same sums (within f32 rounding: the order of the
    additions differs), with repeated rows and dropped ids."""
    mod = _dedup_designs()
    rng = np.random.default_rng(shape[0])
    drop = 20
    rows = torch.from_numpy(rng.integers(0, drop + 1, shape[0]))
    grads = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    ref_u, ref_s = mod.optim.dedup_rows(rows, grads, drop)
    got_u, got_s = mod.dedup_doubling(rows, grads, drop)
    assert torch.equal(got_u, ref_u)
    np.testing.assert_allclose(got_s.numpy(), ref_s.numpy(), rtol=1e-6,
                               atol=1e-6)
