"""The port's blockwise top-k (skrx_torch.ops.kernels.topk_blocks, CPU path:
the plain PyTorch versions) against the JAX package's Pallas kernels run in
interpret mode, on the same numpy-seeded inputs. Selection does no
arithmetic, so values, ids and tau must match exactly."""
import importlib.util
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from skrx.ops import metrics as jmetrics
from skrx.ops.pallas import topk_blocks as jtb
from skrx_torch.ops import metrics as tmetrics
from skrx_torch.ops.kernels import topk_blocks as ttb

NEG_INF = np.float32(-np.inf)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _mask_table(rng, b, n, width, pad=None):
    """Sorted per-row id tables padded with ``pad`` (default n)."""
    table = np.full((b, width), n if pad is None else pad, np.int32)
    for r in range(b):
        cnt = rng.integers(1, width + 1)
        table[r, :cnt] = np.sort(rng.permutation(n)[:cnt])
    return table


# ---------------------------------------------------------------- kth_largest

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kth_largest_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((16, 4096)).astype(np.float32)
    x[1] = np.round(x[1] * 2)              # ties
    x[2, 100:] = -np.inf
    x[3] = -np.abs(x[3]) - 1.0             # negatives only
    x[4] = -np.inf                         # all -inf
    for k in (1, 7, 50, 128):
        ref = np.asarray(jtb.kth_largest(jnp.asarray(x), k, interpret=True))
        got = ttb.kth_largest(_t(x), k).numpy()
        np.testing.assert_array_equal(got.view(np.int32), ref[:, 0].view(np.int32))


def test_kth_largest_signed_zeros_and_subnormals():
    x = np.zeros((8, 256), np.float32)
    x[0, :5] = [-0.0, 0.0, 1e-40, -1e-40, 5e-324]
    x[1] = -0.0
    x[2, :3] = [-0.0, -0.0, 0.0]
    for k in (1, 2, 3, 200):
        ref = np.asarray(jtb.kth_largest(jnp.asarray(x), k, interpret=True))
        got = ttb.kth_largest(_t(x), k).numpy()
        # bit patterns: -0.0 and +0.0 are distinct in the kernel's order
        np.testing.assert_array_equal(got.view(np.int32), ref[:, 0].view(np.int32))


def _kth_rows(w):
    """chip_smoke.py's adversarial rows for kth_largest at width w."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.kth_rows(np.random.default_rng(w), w)


@pytest.mark.parametrize("w", [256, 1408, 4096])
@pytest.mark.parametrize("k", [1, 10, 50, "W"])
def test_kth_largest_matches_jax_at_main_path_widths(w, k):
    """The widths the main path gives kth_largest (chunked evaluation,
    Gowalla serving and evaluation, the folded 1,048,576-item catalog), at
    its k and at k = W; rows with fewer than k finite entries give -inf."""
    k = w if k == "W" else k
    x = _kth_rows(w)
    ref = np.asarray(jtb.kth_largest(jnp.asarray(x), k, interpret=True))
    got = ttb.kth_largest(_t(x), k).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref[:, 0].view(np.int32))
    if k > 5:
        assert got[3] == got[7] == -np.inf


def test_kth_largest_rejects_bad_k():
    with pytest.raises(ValueError):
        ttb.kth_largest(torch.zeros((2, 4)), 5)


# ---------------------------------------------- blockwise_topk and tau (masked)

def _case(name):
    rng = np.random.default_rng(100 + CASES.index(name))
    if name == "ragged_n":                 # N not a multiple of 4096
        b, n, k, block_n = 8, 5000, 10, 4096
        s = rng.standard_normal((b, n)).astype(np.float32)
        return s, _mask_table(rng, b, n, 40), k, block_n, {}
    if name == "batch_tiles":              # B > JAX's block_b
        b, n, k, block_n = 11, 768, 9, 256
        s = rng.standard_normal((b, n)).astype(np.float32)
        return s, _mask_table(rng, b, n, 12), k, block_n, {"block_b": 4}
    if name == "tie_storm":
        b, n, k, block_n = 4, 1024, 7, 128
        s = np.zeros((b, n), np.float32)
        s[:, 700] = 2.0
        return s, _mask_table(rng, b, n, 3), k, block_n, {}
    if name == "mask_dominates":           # train items hold the top scores
        b, n, k, block_n, width = 4, 2000, 10, 256, 64
        s = rng.standard_normal((b, n)).astype(np.float32)
        table = np.stack([np.sort(rng.permutation(n)[:width])
                          for _ in range(b)]).astype(np.int32)
        for r in range(b):
            s[r, table[r]] += 50.0
        return s, table, k, block_n, {}
    if name == "few_unmasked":             # rows with < k unmasked items
        b, n, k, block_n = 6, 600, 17, 128
        s = rng.standard_normal((b, n)).astype(np.float32)
        table = np.full((b, n), n, np.int32)
        table[0] = np.arange(n)                       # fully masked
        table[1, :n - 5] = rng.permutation(n)[:n - 5]  # 5 survivors
        table[2, :n - 16] = np.arange(16, n)           # 16 survivors
        s[3] = -np.inf                                 # all -inf row
        s[4, 300:] = -np.inf
        table[4, :290] = np.arange(290)                # 10 finite left
        table[5, :7] = [-1, n, n + 9, 3, 3, 599, 0]    # padding, duplicates
        return s, table, k, block_n, {}
    raise KeyError(name)


CASES = ["ragged_n", "batch_tiles", "tie_storm", "mask_dominates",
         "few_unmasked"]


@pytest.mark.parametrize("name", CASES)
def test_blockwise_topk_and_tau_match_jax(name):
    s, table, k, block_n, jkw = _case(name)
    ref_v, ref_i = jtb.blockwise_topk(jnp.asarray(s), k, block_n=block_n,
                                      interpret=True,
                                      mask_table=jnp.asarray(table), **jkw)
    _, _, ref_tau = jtb.blockwise_candidates(jnp.asarray(s), k, block_n,
                                             interpret=True,
                                             mask_table=jnp.asarray(table),
                                             **jkw)
    v, i = ttb.blockwise_topk(_t(s), k, block_n=block_n, mask_table=_t(table))
    _, _, tau = ttb.blockwise_candidates(_t(s), k, block_n, _t(table))
    np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(tau.numpy().view(np.int32),
                                  np.asarray(ref_tau)[:, 0].view(np.int32))
    assert i.dtype == torch.int32 and v.dtype == torch.float32


def test_blockwise_topk_default_block_unmasked_matches_jax():
    rng = np.random.default_rng(21)
    s = rng.standard_normal((5, 8192)).astype(np.float32)
    s[2, :] = 0.25                         # row-wide tie storm
    ref_v, ref_i = jtb.blockwise_topk(jnp.asarray(s), 10, interpret=True)
    v, i = ttb.blockwise_topk(_t(s), 10)
    np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))


def test_blockwise_topk_does_not_write_scores():
    rng = np.random.default_rng(4)
    s = rng.standard_normal((3, 900)).astype(np.float32)
    ts = _t(s.copy())
    ttb.blockwise_topk(ts, 5, block_n=256,
                       mask_table=_t(_mask_table(rng, 3, 900, 20)))
    np.testing.assert_array_equal(ts.numpy(), s)


def _extract_oracle(s, table, tau, k, block_n):
    """Block-local top-min(k, #) of the finite masked elements >= tau by
    (value desc, id asc), filler (-inf, SENTINEL) — per-row numpy loop."""
    b, n = s.shape
    nb = -(-n // block_n)
    out_v = np.full((b, nb * k), -np.inf, np.float32)
    out_i = np.full((b, nb * k), ttb.SENTINEL, np.int32)
    for r in range(b):
        row = s[r].copy()
        ids = table[r][(table[r] >= 0) & (table[r] < n)]
        row[ids] = -np.inf
        for j in range(nb):
            cols = np.arange(j * block_n, min(n, (j + 1) * block_n))
            keep = cols[(row[cols] >= tau[r]) & np.isfinite(row[cols])]
            order = sorted(keep, key=lambda c: (-row[c], c))[:k]
            out_v[r, j * k:j * k + len(order)] = row[order]
            out_i[r, j * k:j * k + len(order)] = order
    return out_v, out_i


@pytest.mark.parametrize("name", ["ragged_n", "tie_storm", "few_unmasked"])
def test_extract_candidates_match_oracle(name):
    s, table, k, block_n, _ = _case(name)
    _, _, tau = ttb.blockwise_candidates(_t(s), k, block_n, _t(table))
    v, i = ttb.extract(_t(s), tau, k, _t(table), block_n)
    ref_v, ref_i = _extract_oracle(s, table, tau.numpy(), k, block_n)
    np.testing.assert_array_equal(v.numpy(), ref_v)
    np.testing.assert_array_equal(i.numpy(), ref_i)


def _survivor_case(name):
    """(scores, mask table, k, block_n, survivors per (row, block)): B=4,
    N=2,048 in blocks of 512. "counts": k=50, survivors are columns at
    tau = 1.0 (a few above it, under 50 group maxima, so tau stays 1.0;
    two more a block masked away), the rest below or -inf; the 16 blocks
    hold 0, 1, 31, 32, 33, 49, 50, 51, 256, 257 (F = 256 is the most the
    kernel ranks directly), a block whose every column equals tau, and a
    few. "tau ties": k=10, a row whose every column equals tau, a row of
    +-0.0 over negatives, a row of values rounded to quarters."""
    rng = np.random.default_rng(77)
    b, n, block_n = 4, 2048, 512
    if name == "counts":
        counts = [[0, 1, 31, 32], [33, 49, 50, 51], [256, 257, 3, 7],
                  [512, 2, 5, 0]]
        s = rng.uniform(-3.0, 0.99, (b, n)).astype(np.float32)
        s[rng.random((b, n)) < 0.2] = -np.inf
        table = np.full((b, 8), n, np.int32)
        for r, row in enumerate(counts):
            for j, f in enumerate(row):
                extra = min(2, block_n - f)
                cols = j * block_n + rng.choice(block_n, f + extra,
                                                replace=False)
                s[r, cols] = 1.0
                if f < block_n:                   # a few above tau
                    s[r, cols[extra:extra + 3]] = 1.5
                table[r, 2 * j:2 * j + extra] = cols[:extra]
        return s, table, 50, block_n, np.array(counts)
    s = np.round(rng.standard_normal((b, n)) * 4).astype(np.float32) / 4
    s[0] = 0.75                                        # every column = tau
    s[1] = -1.0 - rng.random(n).astype(np.float32)
    s[1, rng.choice(n, 300, replace=False)] = np.where(
        rng.random(300) < 0.5, -0.0, 0.0)
    table = np.full((b, 6), n, np.int32)
    table[:, :3] = rng.integers(0, n, (b, 3))
    return s, table, 10, block_n, None


@pytest.mark.parametrize("name", ["counts", "tau ties"])
def test_blockwise_topk_at_survivor_boundaries_matches_jax(name):
    """Blocks whose survivor counts sit at every boundary of the kernel's
    selection (one warp, k, F), whole blocks equal to tau and +-0.0 ties:
    the plain route against JAX's blockwise_topk in interpret mode, and
    extract's candidates against the numpy oracle."""
    s, table, k, block_n, found = _survivor_case(name)
    ref_v, ref_i = jtb.blockwise_topk(jnp.asarray(s), k, block_n=block_n,
                                      interpret=True,
                                      mask_table=jnp.asarray(table))
    v, i = ttb.blockwise_topk(_t(s), k, block_n=block_n, mask_table=_t(table))
    np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    _, _, tau = ttb.blockwise_candidates(_t(s), k, block_n, _t(table))
    cv, ci = ttb.extract(_t(s), tau, k, _t(table), block_n)
    ov, oi = _extract_oracle(s, table, tau.numpy(), k, block_n)
    np.testing.assert_array_equal(cv.numpy().view(np.int32), ov.view(np.int32))
    np.testing.assert_array_equal(ci.numpy(), oi)
    if found is not None:                 # the survivors the case meant
        assert (tau.numpy() == 1.0).all()
        masked = ttb._masked_padded(_t(s), _t(table), block_n)
        got = (masked >= 1.0).reshape(4, -1, block_n).sum(2).numpy()
        np.testing.assert_array_equal(got, found)


def _assert_same_max(got, ref):
    """Non-NaN values equal as int32 views (so -0.0 differs from +0.0); NaN
    where the reference is NaN, by isnan: JAX's NaN bits are the
    backend's."""
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got.view(np.int32)[~nan],
                                  ref.view(np.int32)[~nan])


# column t of a 2-column group (block_n 256) in rows 0 and 1 of the case
SUBMAX_GROUPS = {"random": None, "+0, -0": (0.0, -0.0), "-0, +0": (-0.0, 0.0),
                 "-0, -0": (-0.0, -0.0), "NaN": (np.nan, 1.0)}


@pytest.mark.parametrize("case", list(SUBMAX_GROUPS))
def test_submax_layout_matches_jax_fold(case):
    """Group l of block j is column j*128 + l: the layout JAX's threshold
    pass writes (checked through its own fold of the same scores), with its
    max: NaN when the group holds one, otherwise -0.0 below +0.0 (a plain
    amax keeps whichever zero comes first)."""
    rng = np.random.default_rng(8)
    b, n, block_n = 3, 1000, 256
    s = rng.standard_normal((b, n)).astype(np.float32)
    table = _mask_table(rng, b, n, 30)
    if SUBMAX_GROUPS[case] is not None:
        first, second = SUBMAX_GROUPS[case]
        half = (np.arange(n) % block_n) // 128
        s[:2] = np.where(half == 0, first, second)
        s[1, ::3] = -1.0                   # groups of one zero or NaN
        s[2, ::7] = first                  # a few among normals
    masked = np.asarray(jmetrics.mask_items(jnp.asarray(s), jnp.asarray(table)))
    pad = np.full((b, 4 * block_n), -np.inf, np.float32)
    pad[:, :n] = masked
    ref = np.concatenate([np.asarray(jtb._fold(jnp.asarray(
        pad[:, j * block_n:(j + 1) * block_n]), jnp.maximum))
        for j in range(4)], axis=1)
    got = ttb.submax(_t(s), _t(table), block_n).numpy()
    _assert_same_max(got, ref)
    if case == "NaN":
        assert np.isnan(ref[0]).sum() > 400
    elif case != "random":                 # the pair's max is in row 0
        want = np.float32(0.0 if "+0" in case else -0.0).view(np.int32)
        assert (ref[0].view(np.int32) == want).sum() > 400


@pytest.mark.parametrize("case", ["signed zeros", "NaN"])
def test_fold_submaxes_matches_jax(case):
    """fold_submaxes folds as JAX's _fold_submaxes (jnp.maximum): -0.0
    below +0.0 (torch.maximum(-0.0, +0.0) is -0.0), NaN kept; odd 128-lane
    counts padded with -inf."""
    rng = np.random.default_rng(9)
    bm = rng.standard_normal((4, 128 * 75)).astype(np.float32)
    if case == "signed zeros":
        bm[:, ::2] = np.where(rng.random((4, 128 * 75 // 2)) < 0.5, -0.0, 0.0)
        bm[:, 1::2] = np.where(rng.random((4, 128 * 75 // 2)) < 0.5, -0.0, 0.0)
        bm[2] = -0.0
    else:
        bm[:, ::97] = np.nan
    for k in (10, 50, 3000):
        ref = np.asarray(jtb._fold_submaxes(
            jnp.asarray(bm), max(4096, 2 * (-(-k // 128) * 128))))
        got = ttb.fold_submaxes(_t(bm), k).numpy()
        assert got.shape == ref.shape
        _assert_same_max(got, ref)


# -------------------------------------------------- pruned_merge and vmem_topk

def _merge_inputs(seed, b, w, dup):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((b, w)).astype(np.float32)
    ids = np.stack([rng.permutation(w) for _ in range(b)]).astype(np.int32)
    if dup:                                # repeat (value, id) pairs
        for r in range(b):
            src = rng.integers(0, w, 6)
            dst = rng.integers(0, w, 6)
            vals[r, dst], ids[r, dst] = vals[r, src], ids[r, src]
        top = np.argmax(vals[0])
        vals[0, :5], ids[0, :5] = vals[0, top], ids[0, top]
        vals[1] = np.round(vals[1])        # value ties across ids
    return vals, ids


def _distinct_kth(vals, ids, k):
    out = np.empty(vals.shape[0], np.float32)
    for r in range(vals.shape[0]):
        pairs = sorted(set(zip(vals[r].tolist(), ids[r].tolist())),
                       key=lambda p: (-p[0], p[1]))
        out[r] = pairs[k - 1][0] if len(pairs) >= k else -np.inf
    return out


@pytest.mark.parametrize("seed,w,k,dup", [(0, 300, 17, True),
                                          (1, 2000, 10, True),
                                          (2, 110, 10, False)])
def test_pruned_merge_matches_jax(seed, w, k, dup):
    vals, ids = _merge_inputs(seed, 6, w, dup)
    vals[3, 4:] = -np.inf                  # fewer than k finite: tau -inf
    tau = _distinct_kth(vals, ids, k)
    ref_v, ref_i = jtb.pruned_merge(jnp.asarray(vals), jnp.asarray(ids), k,
                                    jnp.asarray(tau), interpret=True)
    v, i = ttb.pruned_merge(_t(vals), _t(ids), k, _t(tau))
    np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))


def _wide_merge_case(name):
    """The adversarial merge inputs of tests/test_pallas_topk.py: a tie storm
    across JAX's merge chunk boundaries (ids reversed around the first), and
    the same (value, id) pair repeated in every chunk."""
    cb = jtb._MERGE_CHUNK_W
    if name == "chunk_boundary_tie_storm":
        w, k = 2 * cb + 600, 20
        vals = np.zeros((3, w), np.float32)
        ids = np.broadcast_to(np.arange(w, dtype=np.int32), (3, w)).copy()
        storm = list(range(cb - 8, cb + 8)) + list(range(2 * cb - 4,
                                                         2 * cb + 4))
        vals[:, storm] = 5.0
        ids[:, cb - 8:cb + 8] = ids[:, cb - 8:cb + 8][:, ::-1]
        vals[:, 100:110] = 3.0
        return vals, ids, k
    w, k = 2 * cb + 100, 8
    rng = np.random.default_rng(7)
    vals = rng.uniform(-1.0, 0.0, (4, w)).astype(np.float32)
    ids = np.broadcast_to(np.arange(w, dtype=np.int32), (4, w)).copy()
    for col in (77, cb + 5, 2 * cb + 5):
        vals[:, col], ids[:, col] = 9.0, 77
    for col in (500, cb + 600):
        vals[:, col], ids[:, col] = 8.0, 500
    return vals, ids, k


@pytest.mark.parametrize("name", ["chunk_boundary_tie_storm",
                                  "duplicate_pairs_across_chunks"])
def test_wide_merge_adversarial_matches_jax(name):
    """vmem_topk and pruned_merge (one pass, no width chunks) against JAX's
    chunked merge_topk, without and with tau."""
    vals, ids, k = _wide_merge_case(name)
    ref_v, ref_i = jtb.merge_topk(jnp.asarray(vals), jnp.asarray(ids), k,
                                  interpret=True)
    v, i = ttb.vmem_topk(_t(vals), _t(ids), k)
    np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    tau = _distinct_kth(vals, ids, k)
    v, i = ttb.pruned_merge(_t(vals), _t(ids), k, _t(tau))
    np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))


@pytest.mark.parametrize("seed,w,k", [(3, 300, 17), (4, 129, 40)])
def test_vmem_topk_matches_jax(seed, w, k):
    vals, ids = _merge_inputs(seed, 9, w, True)
    vals[2, :] = 0.0                       # full-row tie storm
    vals[4, 10:] = -np.inf
    ref_v, ref_i = jtb.vmem_topk(jnp.asarray(vals), jnp.asarray(ids), k,
                                 interpret=True)
    v, i = ttb.vmem_topk(_t(vals), _t(ids), k)
    np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("k,chunk_w", [(50, 8192), (50, 21), (10, 8192)])
def test_chunked_merge_matches_jax(k, chunk_w):
    """The chunked evaluation's merge (the running best, sorted, empty
    slots (-inf, N + 1), beside one chunk's sorted top-k, empty slots
    (-inf, SENTINEL); the last Gowalla chunk has 21 items): vmem_topk
    against JAX's vmem_topk in interpret mode."""
    vals, ids = _chip_smoke().chunk_rows(np.random.default_rng(k + chunk_w),
                                         k, chunk_w)
    ref_v, ref_i = jtb.vmem_topk(jnp.asarray(vals), jnp.asarray(ids), k,
                                 interpret=True)
    v, i = ttb.vmem_topk(_t(vals), _t(ids), k)
    np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))


@pytest.mark.parametrize("k", [10, 50])
def test_merge_at_survivor_boundaries_matches_jax(k):
    """Rows of k, k + 1, F and F + 1 survivors (F: the most survivors the
    kernel ranks directly, above it k argmax rounds) at tau = 1.0, a valid
    bound: pruned_merge against JAX's pruned_merge, and vmem_topk on the
    same rows against JAX's vmem_topk, in interpret mode (no signed zeros
    or NaN: JAX orders them otherwise)."""
    vals, ids, tau, founds = _chip_smoke().merge_rows(
        np.random.default_rng(k), k)
    cap = _chip_smoke().MERGE_CAP
    rows = [founds.index(f) for f in (k, k + 1, cap, cap + 1)]
    vals, ids, tau = vals[rows], ids[rows], tau[rows]
    assert ((vals >= 1.0).sum(1) == [k, k + 1, cap, cap + 1]).all()
    ref_v, ref_i = jtb.pruned_merge(jnp.asarray(vals), jnp.asarray(ids), k,
                                    jnp.asarray(tau), interpret=True)
    v, i = ttb.pruned_merge(_t(vals), _t(ids), k, _t(tau))
    np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    ref_v, ref_i = jtb.vmem_topk(jnp.asarray(vals), jnp.asarray(ids), k,
                                 interpret=True)
    v, i = ttb.vmem_topk(_t(vals), _t(ids), k)
    np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))


def test_rank_key_orders_as_rank_count_plain():
    """The kernel's packed key in plain PyTorch: key(c) < key(p, probe)
    exactly when rank_count_plain counts candidate c before probe p, on
    every pair drawn from +-0.0, +-inf, NaN, subnormals, +-FLT_MAX and ids
    {INT_MIN, -1, 0, 1, INT_MAX // 2, INT_MAX}; and counting with it gives
    rank_count_plain's counts."""
    fmax = np.finfo(np.float32).max
    values = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-45,
                       -1e-45, 1e-40, -1e-40, fmax, -fmax, 1.0, -1.0],
                      np.float32)
    id_set = np.array([-2 ** 31, -1, 0, 1, 2 ** 31 // 2 - 1, 2 ** 31 - 1],
                      np.int32)
    v, i = (x.ravel() for x in np.meshgrid(values, id_set, indexing="ij"))
    v, i = _t(v), _t(i)
    got = ttb.rank_key(v, i)[:, None] < ttb.rank_key(v, i, probe=True)[None]
    want = (v[:, None] > v[None]) | ((v[:, None] == v[None])
                                     & (i[:, None] < i[None]))
    assert torch.equal(got, want)
    counts = ttb.rank_count_plain(v[None], i[None], v[None], i[None])
    assert torch.equal(counts[0], got.sum(0, dtype=torch.int32))


# ------------------------------------------------------ topk_scores_and_indices

@pytest.mark.parametrize("b,n,k,masked", [(7, 300, 10, True),
                                          (5, 50, 10, False),
                                          (4, 6, 10, True),
                                          (4, 6, 10, False)])
def test_topk_scores_and_indices_matches_jax(b, n, k, masked):
    rng = np.random.default_rng(n + k)
    # ties, and signed zeros that lax.top_k orders -0.0 below +0.0
    s = np.round(rng.standard_normal((b, n)) * 3).astype(np.float32)
    table = _mask_table(rng, b, n, min(n, 8)) if masked else None
    jt = None if table is None else jnp.asarray(table)
    ref_v, ref_i = jmetrics.topk_scores_and_indices(jnp.asarray(s), k,
                                                    mask_table=jt)
    v, i = tmetrics.topk_scores_and_indices(
        _t(s), k, mask_table=None if table is None else _t(table))
    np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))


def test_mask_items_matches_jax():
    rng = np.random.default_rng(12)
    s = rng.standard_normal((4, 40)).astype(np.float32)
    table = _mask_table(rng, 4, 40, 9)
    table[0, -1] = 41                      # out of range: padding
    ref = jmetrics.mask_items(jnp.asarray(s), jnp.asarray(table))
    got = tmetrics.mask_items(_t(s), _t(table))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
