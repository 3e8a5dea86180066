"""The evaluation slice: the port's rank counts, metrics, RankingEvaluator
and EarlyStopping against the JAX package's on the same numpy-seeded inputs
(the port on the CPU runs the kernels' plain versions; JAX's Pallas kernels
run in interpret mode). Counting does no arithmetic, so ranks match
exactly; metrics within 1e-6 (float32 sums in another order)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from skrx.eval import EarlyStopping as JaxEarlyStopping
from skrx.eval import MetricReport as JaxMetricReport
from skrx.eval import RankingEvaluator as JaxRankingEvaluator
from skrx.ops import metrics as jmetrics
from skrx.ops.pallas import topk_blocks as jtb
from skrx_torch import RunConfig
from skrx_torch.eval import EarlyStopping, MetricReport, RankingEvaluator
from skrx_torch.ops import metrics as tmetrics
from skrx_torch.ops.kernels import topk_blocks as ttb

SENTINEL = np.iinfo(np.int32).max // 2


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _tables(rng, b, n, train_w, test_w):
    """Per row a disjoint train list (padded with n, unsorted) and test list
    (padded with n), as the evaluator builds them."""
    train = np.full((b, train_w), n, np.int32)
    test = np.full((b, test_w), n, np.int32)
    lens = np.zeros(b, np.int32)
    for r in range(b):
        items = rng.permutation(n)
        ntr, nte = rng.integers(1, train_w + 1), rng.integers(1, test_w + 1)
        train[r, :ntr] = items[:ntr]
        test[r, :nte] = items[ntr:ntr + nte]
        lens[r] = nte
    return train, test, lens


# ------------------------------------------------------- kernel 6: rank_count

@pytest.mark.parametrize("seed,b,w,t", [(0, 8, 550, 128), (1, 3, 130, 1),
                                        (2, 16, 300, 37)])
def test_rank_count_plain_matches_jax(seed, b, w, t):
    rng = np.random.default_rng(seed)
    vals = np.round(rng.standard_normal((b, w)) * 2).astype(np.float32)
    ids = np.stack([rng.permutation(4 * w)[:w] for _ in range(b)]
                   ).astype(np.int32)
    vals[0, w // 2:] = -np.inf                  # empty candidate slots
    ids[0, w // 2:] = SENTINEL
    pick = rng.integers(0, w, (b, t))
    s_t = np.take_along_axis(vals, pick, 1)     # probes tie with candidates
    t_ids = np.take_along_axis(ids, pick, 1)
    s_t[:, 0] = 0.5                             # and some that do not
    ref = np.asarray(jtb._rank_counts(jnp.asarray(vals), jnp.asarray(ids),
                                      jnp.asarray(s_t), jnp.asarray(t_ids),
                                      interpret=True))
    got = ttb.rank_count(_t(vals), _t(ids), _t(s_t), _t(t_ids)).numpy()
    np.testing.assert_array_equal(got, ref)


# ------------------------------------------ masked_topk_ranks (route of #6)

def _probe_case(seed, b, n, t, width):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((b, n)).astype(np.float32)
    s[1] = np.round(s[1] * 3)                   # ties
    s[2, ::7] = -np.inf
    mask = rng.integers(0, n, (b, width)).astype(np.int32)
    mask[:, -3:] = n                            # padding
    probes = rng.integers(0, n + 4, (b, t)).astype(np.int32)
    probes[:, :3] = mask[:, :3]                 # masked probes
    probes[2, 3] = 0                            # scored -inf
    probes[:, 4] = probes[:, 5]                 # duplicates
    masked = s.copy()
    for r in range(b):
        masked[r, mask[r][mask[r] < n]] = -np.inf
    m = min(8, t - 6)                           # some probes rank < k
    probes[:, 6:6 + m] = np.argsort(-masked, axis=1, kind="stable")[:, :m]
    return s, mask, probes


@pytest.mark.parametrize("t", [40, 200])
def test_masked_topk_ranks_matches_jax(t):
    """min(rank, k) equal to JAX's for T <= 128 (its kernel) and T > 128
    (its XLA broadcast): at and above k the two candidate sets differ."""
    k = 10
    s, mask, probes = _probe_case(t, 6, 4100, t, 24)
    ref = np.asarray(jtb.masked_topk_ranks(
        jnp.asarray(s), k, jnp.asarray(probes), mask_table=jnp.asarray(mask),
        interpret=True))
    got = ttb.masked_topk_ranks(_t(s), k, _t(probes), _t(mask)).numpy()
    np.testing.assert_array_equal(np.minimum(got, k), np.minimum(ref, k))
    assert (got < k).sum() > 0 and (got[:, :3] == k).all()


# ------------------------------------ kernel 8: masked_topk_ranks_small

def _special_rows(s, probes, special):
    """NaN, signed zeros or +inf written into rows 0 and 3, each beside a
    NaN of row 4 (a NaN anywhere in a row once moved every rank of it)."""
    s[4, 1::9] = np.nan
    if special == "nan":
        s[0, 2::5] = np.nan
        s[3, 1] = np.nan
        probes[0, 0] = 7                        # a probe scored NaN
        probes[3, :4] = (0, 3, 6, 7)
    elif special == "signed zeros":
        s[0, 10:30] = np.where(np.arange(20) % 2, 0.0, -0.0)
        s[3, 40:46] = (0.0, -0.0, 0.0, -0.0, 0.0, -0.0)
        probes[0, :6] = (10, 11, 16, 17, 28, 29)
        probes[3, :6] = np.arange(40, 46)
    else:                                       # +inf
        s[0, 3:30:4] = np.inf
        s[3, 50] = np.inf
        probes[0, :3] = (3, 4, 5)               # one scored +inf
        probes[3, :2] = (50, 51)
    probes[4, 7:10] = (1, 2, 3)                 # a NaN and its neighbours


@pytest.mark.parametrize("seed,n,t,masked,special", [
    pytest.param(0, 300, 40, True, None, id="0-300-40-True"),
    pytest.param(1, 1000, 128, True, None, id="1-1000-128-True"),
    pytest.param(2, 257, 9, False, None, id="2-257-9-False"),
    (3, 128, 12, False, "nan"),
    (4, 300, 40, True, "nan"),
    (5, 300, 40, True, "signed zeros"),
    (6, 257, 40, False, "+inf"),
])
def test_masked_topk_ranks_small_matches_jax(seed, n, t, masked, special):
    k = 20
    s, mask, probes = _probe_case(seed, 5, n, t, 30)
    if special:
        _special_rows(s, probes, special)
    ref = np.asarray(jtb.masked_topk_ranks_small(
        jnp.asarray(s), k, jnp.asarray(probes),
        mask_table=jnp.asarray(mask) if masked else None, interpret=True))
    got = ttb.masked_topk_ranks_small(_t(s), k, _t(probes),
                                      _t(mask) if masked else None).numpy()
    np.testing.assert_array_equal(got, ref)


def test_direct_rank_plain_is_exact_on_rows_wider_than_its_slices():
    """A row of more than 2**20 columns (one probe a slice) and 300 probes:
    every found probe's exact position in the row's (value desc, id asc)
    order, NaN columns left out, as numpy's lexsort gives it."""
    rng = np.random.default_rng(9)
    b, n, t, k = 2, 2 ** 20 + 3, 300, 50
    s = np.round(rng.standard_normal((b, n)) * 4).astype(np.float32)
    s[:, 3::1001] = np.nan
    s[0, 5::7] = -0.0
    mask = rng.integers(0, n, (b, 64)).astype(np.int32)
    probes = rng.integers(-2, n + 2, (b, t)).astype(np.int32)
    probes[:, 0], probes[:, 1], probes[0, 2] = 3, mask[:, 0], 5
    got = ttb.direct_rank_plain(_t(s), _t(mask), _t(probes), k).numpy()
    for r in range(b):
        v = s[r].copy()
        v[mask[r]] = -np.inf
        v = np.where(v == 0.0, 0.0, v)                 # -0.0 ties +0.0
        keep = ~np.isnan(v)
        order = np.lexsort((np.arange(n)[keep], -v[keep]))
        pos = np.full(n, -1)
        pos[np.flatnonzero(keep)[order]] = np.arange(keep.sum())
        for q, i in enumerate(probes[r]):
            hit = 0 <= i < n and np.isfinite(v[i])
            assert got[r, q] == (pos[i] if hit else k), (r, q)
    assert (got[:, :2] == k).all() and got[0, 2] != k
    assert (got > k).sum() > 200


def test_direct_rank_any_t_equals_the_blockwise_route_below_k():
    k = 10
    s, mask, probes = _probe_case(5, 4, 3000, 300, 50)
    small = ttb.direct_rank(_t(s), _t(probes), k, _t(mask))
    big = ttb.masked_topk_ranks(_t(s), k, _t(probes), _t(mask))
    assert torch.equal(small.clamp(max=k), big.clamp(max=k))
    assert (small < k).sum() >= 4


# ------------------------------------------------------------------ metrics

def test_hits_match_jax():
    rng = np.random.default_rng(3)
    ranks = rng.integers(0, 15, (9, 12)).astype(np.int32)
    np.testing.assert_array_equal(
        tmetrics.hits_from_ranks(_t(ranks), 10).numpy(),
        np.asarray(jmetrics.hits_from_ranks(jnp.asarray(ranks), 10)))
    top = rng.integers(0, 30, (9, 10)).astype(np.int32)
    truth = rng.integers(0, 31, (9, 6)).astype(np.int32)
    np.testing.assert_array_equal(
        tmetrics.hits_against_padded_truth(_t(top), _t(truth)).numpy(),
        np.asarray(jmetrics.hits_against_padded_truth(jnp.asarray(top),
                                                      jnp.asarray(truth))))


def test_ranking_metrics_from_hits_match_jax():
    rng = np.random.default_rng(4)
    hits = (rng.random((32, 50)) < 0.2).astype(np.float32)
    truth_len = rng.integers(0, 70, 32).astype(np.int32)
    ids = (1, 2, 3, 4, 5)
    np.testing.assert_allclose(
        tmetrics.ranking_metrics_from_hits(_t(hits), _t(truth_len),
                                           ids).numpy(),
        np.asarray(jmetrics.ranking_metrics_from_hits(
            jnp.asarray(hits), jnp.asarray(truth_len), ids)),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,top_k", [(300, (5, 10, 20)), (3000, (10,))])
def test_eval_score_matrix_device_matches_jax(n, top_k):
    """Both port routes (direct count at N=300, candidates at N=3000)
    against JAX's CPU route (masked lax.top_k, then id hits)."""
    rng = np.random.default_rng(n)
    b, k = 16, max(top_k)
    scores = rng.standard_normal((b, n)).astype(np.float32)
    train, test, lens = _tables(rng, b, n, 40, 12)
    ids = (1, 2, 3, 4, 5)
    ref = np.asarray(jmetrics.eval_score_matrix_device(
        jnp.asarray(scores), jnp.asarray(train), jnp.asarray(test),
        jnp.asarray(lens), ids, k))
    got = tmetrics.eval_score_matrix_device(_t(scores), _t(train), _t(test),
                                            _t(lens), ids, k).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


# ---------------------------------------------------------------- evaluator

class _Stub:
    """A model whose scores are a fixed numpy matrix."""

    def __init__(self, scores):
        self.scores = scores
        self.num_items = scores.shape[1]

    def predict(self, users):
        return self.scores[np.asarray(users, dtype=np.int64)]


@pytest.mark.parametrize("n,top_k,bs", [(200, (5, 10, 20), 16),
                                        (2600, (10,), 32)])
def test_evaluator_matches_jax(n, top_k, bs):
    rng = np.random.default_rng(n + bs)
    users = 70
    scores = rng.standard_normal((users, n)).astype(np.float32)
    train, test = {}, {}
    for u in range(users):
        items = rng.permutation(n)
        ntr, nte = rng.integers(1, 30), rng.integers(0, 9)
        train[u] = items[:ntr].astype(np.int32)
        if nte:                                  # some users have no test
            test[u] = items[ntr:ntr + nte].astype(np.int32)
    metrics = ("Precision", "Recall", "MAP", "NDCG", "MRR")
    jev = JaxRankingEvaluator(train, test, metric=metrics, top_k=top_k,
                              batch_size=bs)
    tev = RankingEvaluator(train, test, metric=metrics, top_k=top_k,
                           batch_size=bs, device="cpu")
    assert tev.metrics_list == jev.metrics_list
    model = _Stub(scores)
    for subset in (None, list(range(0, users, 3)) + [users + 5]):
        ref = jev.evaluate(model, subset)
        got = tev.evaluate(model, subset)
        assert list(got.metrics()) == list(ref.metrics())
        np.testing.assert_allclose(list(got.values()), list(ref.values()),
                                   rtol=0, atol=1e-6)
    # the device tables are built once per user set
    assert len(tev._lru) == 2
    tev.evaluate(model)
    assert len(tev._lru) == 2


def test_evaluator_refuses_modes_not_ported():
    """"topk" is refused without a mesh whose model axis is above 1 (it
    ranks the catalog split over that axis); "chunked" and "fused" are
    built, with their chunk settings."""
    train, test = {0: np.array([1])}, {0: np.array([2])}
    with pytest.raises(ValueError, match="model axis is above 1"):
        RankingEvaluator(train, test, eval_mode="topk", device="cpu")
    for mode in ("auto", "full", "chunked", "fused"):
        ev = RankingEvaluator(train, test, eval_mode=mode, chunk_size=512,
                              chunk_threshold=1024, device="cpu")
        assert (ev.eval_mode, ev.chunk_size, ev.chunk_threshold) == (
            mode, 512, 1024)
    for bad in (dict(eval_mode="paged"), dict(chunk_size=0)):
        with pytest.raises(ValueError):
            RankingEvaluator(train, test, device="cpu", **bad)
    with pytest.raises(ValueError):
        RunConfig(eval_chunk_threshold=0)
    assert (RunConfig().eval_chunk_size, RunConfig().eval_chunk_threshold) \
        == (65536, 131072)
    with pytest.raises(ValueError):
        RankingEvaluator(train, {}, device="cpu")
    with pytest.raises(ValueError):
        RankingEvaluator(train, test, metric=("AUC",), device="cpu")
    with pytest.raises(ValueError):
        RunConfig(eval_mode="paged")
    with pytest.raises(ValueError):
        RunConfig(test_batch_size="big")
    run = RunConfig(metric="NDCG", top_k=5, test_batch_size="auto")
    assert run.metric == ("NDCG",) and run.top_k == (5,)


def test_metric_report_and_early_stopping_match_jax():
    names = ["NDCG@10", "Recall@10"]
    seq = [0.10, 0.12, 0.11, 0.12, 0.13, 0.09, 0.08, 0.07]
    jes, tes = JaxEarlyStopping("NDCG@10", 2), EarlyStopping("NDCG@10", 2)
    for v in seq:
        jr, tr = JaxMetricReport(names, [v, 2 * v]), MetricReport(names,
                                                                  [v, 2 * v])
        assert tr.values_str == jr.values_str
        assert tr.metrics_str == jr.metrics_str
        assert tes(tr) == jes(jr)
        assert tes.get_state() == jes.get_state()
    assert tes.best_result["NDCG@10"] == jes.best_result["NDCG@10"] == 0.13
    fresh = EarlyStopping("NDCG@10", 2)
    fresh.set_state(tes.get_state())
    assert fresh.get_state() == tes.get_state()
    assert EarlyStopping().best_result["None"] == 0.0
    with pytest.raises(ValueError):
        MetricReport(names, [1.0])
