"""Fused score-and-select (kernels #9 dot_submax, #10 dot_extract and #7
rank_lookup_count): the port's plain versions against the JAX package's
``dot_topk``, ``dot_topk_candidates``, ``dot_topk_ranks`` and
``_rank_lookup_counts`` in interpret mode, on the same numpy-seeded inputs.

Dyadic inputs (small integers over a power of two, d <= 16) make every dot
product exact in f32 on both sides, so values, ids and tau are equal; with
N(0, 1) inputs the two score orders round differently, and values agree
within 1e-5 and ids wherever the ranking is separated by more than that.
Ranks are equal below k (at and above k the candidate sets differ)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from skrx.ops.metrics import hits_against_padded_truth
from skrx.ops.pallas import topk_blocks as jtb
from skrx.ops.pallas.dot_topk import dot_topk as jax_dot_topk
from skrx.ops.pallas.dot_topk import dot_topk_candidates as jax_candidates
from skrx.ops.pallas.dot_topk import dot_topk_ranks as jax_dot_topk_ranks
from skrx_torch.ops import metrics as tmetrics
from skrx_torch.ops.kernels import dot_topk as tdt
from skrx_torch.ops.kernels import runtime
from skrx_torch.ops.kernels import topk_blocks as ttb

SENTINEL = np.iinfo(np.int32).max // 2


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _case(seed, b, n, d, dyadic=True, bias=True, dup=False, width=24):
    """(uv, items, bias, mask): a mask table with padding (n) and
    out-of-range entries; ``dup`` repeats item rows (exact score ties)."""
    rng = np.random.default_rng(seed)
    if dyadic:
        uv = rng.integers(-8, 9, (b, d)) / 4
        items = rng.integers(-8, 9, (n, d)) / 8
        bv = rng.integers(-16, 17, n) / 16
    else:
        uv, items = rng.standard_normal((b, d)), rng.standard_normal((n, d))
        bv = rng.standard_normal(n)
    if dup:
        items[n // 2: n // 2 + 60] = items[:60]
    mask = rng.integers(0, n, (b, max(width, 6)))
    mask[:, -3:] = n                            # padding
    mask[:, 0] = -1                             # out of range
    f32 = lambda x: x.astype(np.float32)
    return (f32(uv), f32(items), f32(bv) if bias else None,
            mask.astype(np.int32) if width else None)


CASES = [  # (seed, b, n, d, k, block_n, bias, dup, mask width)
    (0, 9, 1500, 16, 17, 256, True, False, 24),    # N not a block multiple
    (1, 6, 520, 8, 10, 512, False, False, 30),     # no bias, one block
    (2, 11, 2000, 12, 50, 256, True, True, 0),     # duplicated rows, no mask
]


@pytest.mark.parametrize("seed,b,n,d,k,block_n,bias,dup,width", CASES)
def test_dot_topk_and_tau_equal_jax_on_dyadic_inputs(seed, b, n, d, k,
                                                     block_n, bias, dup,
                                                     width):
    uv, items, bv, mask = _case(seed, b, n, d, bias=bias, dup=dup,
                                width=width)
    _, _, jtau = jax_candidates(_j(uv), _j(items), _j(bv), k, _j(mask),
                                block_n=block_n, interpret=True)
    jv, ji = jax_dot_topk(_j(uv), _j(items), _j(bv), k, mask_table=_j(mask),
                          block_n=block_n, interpret=True)
    _, _, tau = tdt.dot_topk_candidates(_t(uv), _t(items), _t(bv), k,
                                        _t(mask), block_n)
    v, i = tdt.dot_topk(_t(uv), _t(items), _t(bv), k, _t(mask), block_n)
    np.testing.assert_array_equal(tau.numpy(), np.asarray(jtau)[:, 0])
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    if dup:                                     # the tied copies both rank
        assert np.isin(i.numpy(), np.arange(n // 2, n // 2 + 60)).any()


def test_dot_topk_matches_jax_on_normal_inputs():
    uv, items, bv, mask = _case(3, 10, 1800, 16, dyadic=False)
    k = 20
    jv, ji = jax_dot_topk(_j(uv), _j(items), _j(bv), k, mask_table=_j(mask),
                          block_n=256, interpret=True)
    v, i = tdt.dot_topk(_t(uv), _t(items), _t(bv), k, _t(mask), 256)
    jv, ji = np.asarray(jv), np.asarray(ji)
    np.testing.assert_allclose(v.numpy(), jv, rtol=1e-5, atol=1e-6)
    gap = np.abs(np.diff(jv, axis=1)) > 1e-5
    sep = np.ones_like(ji, dtype=bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    assert sep.mean() > 0.9
    np.testing.assert_array_equal(i.numpy()[sep], ji[sep])


def _probes(rng, ids, mask, n, t):
    """Probes: the row's top ids (ranks < k occur), masked ids, padding
    (n), out of range, duplicated, and random ids."""
    p = rng.integers(-2, n + 2, (ids.shape[0], t))
    p[:, :6] = ids[:, :6]
    p[:, 6:9] = mask[:, 3:6]                    # masked
    p[:, 9], p[:, 10], p[:, 11] = n, -5, n + 7  # padding, out of range
    p[:, 12:14] = p[:, 2:3]                     # duplicated
    return p.astype(np.int32)


@pytest.mark.parametrize("t", [40, 150])
def test_dot_topk_ranks_match_jax(t):
    """T <= 128 against JAX's dot_topk_ranks (min(rank, k) equal); T > 128,
    which JAX sends to dot_topk plus an id compare, against those hits."""
    k = 10
    uv, items, bv, mask = _case(4, 8, 1300, 16)
    rng = np.random.default_rng(t)
    ids = tdt.dot_topk(_t(uv), _t(items), _t(bv), k, _t(mask), 256)[1]
    probes = _probes(rng, ids.numpy(), mask, 1300, t)
    ranks = tdt.dot_topk_ranks(_t(uv), _t(items), _t(bv), k, _t(probes),
                               _t(mask), 256).numpy()
    assert (ranks < k).sum() >= 8 and (ranks[:, 6:12] == k).all()
    if t <= 128:
        ref = np.asarray(jax_dot_topk_ranks(
            _j(uv), _j(items), _j(bv), k, _j(probes), mask_table=_j(mask),
            block_n=256, interpret=True))
        np.testing.assert_array_equal(np.minimum(ranks, k),
                                      np.minimum(ref, k))
    else:
        _, ji = jax_dot_topk(_j(uv), _j(items), _j(bv), k,
                             mask_table=_j(mask), block_n=256, interpret=True)
        ref = np.asarray(hits_against_padded_truth(ji, _j(probes)))
        got = tmetrics.hits_from_ranks(_t(ranks), k).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed,b,w,t,repeats", [(0, 8, 550, 128, False),
                                                (1, 5, 130, 3, False),
                                                (2, 6, 300, 40, True)])
def test_rank_lookup_count_plain_matches_jax(seed, b, w, t, repeats):
    """With ``repeats`` probe ids 1-3 of every row repeat among the
    candidates: one copy NaN beside a finite one (the score is NaN: not
    found, rank 0), one copy -inf beside a finite one, two finite copies
    (the larger is the score)."""
    rng = np.random.default_rng(seed)
    vals = np.round(rng.standard_normal((b, w)) * 2).astype(np.float32)
    ids = np.stack([rng.permutation(4 * w)[:w] for _ in range(b)]
                   ).astype(np.int32)
    vals[0, w // 2:], ids[0, w // 2:] = -np.inf, SENTINEL   # empty slots
    probes = np.take_along_axis(ids, rng.integers(0, w, (b, t)), 1)
    probes[:, 0] = 4 * w + 1                    # among no candidates
    probes[0, -1] = ids[0, -1]                  # a -inf lane: not found
    if repeats:
        ids[:, 2], vals[:, 2] = ids[:, 1], np.nan
        ids[:, 4], vals[:, 4] = ids[:, 3], -np.inf
        ids[:, 6], vals[:, 6] = ids[:, 5], vals[:, 5] + 1.5
        probes[:, 1:4] = ids[:, [1, 3, 5]]
    ref_r, ref_f = jtb._rank_lookup_counts(_j(vals), _j(ids), _j(probes),
                                           interpret=True)
    got_r, got_f = ttb.rank_lookup_count(_t(vals), _t(ids), _t(probes))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(ref_r))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(ref_f))
    assert got_f.dtype == torch.bool and not got_f[:, 0].any()
    if repeats:
        assert not got_f[:, 1].any() and not got_r[:, 1].any()
        assert bool(got_f[:, 2:4].all())


def test_rank_lookup_count_any_t_equals_rank_count_of_the_looked_up_scores():
    rng = np.random.default_rng(7)
    vals = np.round(rng.standard_normal((4, 300))).astype(np.float32)
    ids = np.stack([rng.permutation(300) for _ in range(4)]).astype(np.int32)
    probes = rng.integers(0, 300, (4, 200)).astype(np.int32)
    ranks, found = ttb.rank_lookup_count(_t(vals), _t(ids), _t(probes))
    s_t = np.take_along_axis(vals, np.argsort(ids, 1), 1)
    s_t = np.take_along_axis(s_t, probes, 1)
    assert bool(found.all())
    assert torch.equal(ranks, ttb.rank_count(_t(vals), _t(ids), _t(s_t),
                                             _t(probes)))


@pytest.mark.parametrize("d", [8, 13])
def test_fused_candidates_equal_the_score_matrix_route_on_dyadic_inputs(d):
    """Exact scores: dot_submax / dot_extract equal submax / extract of the
    materialized matrix, and their plain versions the wrappers."""
    uv, items, bv, mask = _case(5, 7, 1100, d)
    scores = torch.from_numpy((uv.astype(np.float64) @ items.T.astype(
        np.float64) + bv).astype(np.float32))
    packed = tdt.pack_items(_t(items), _t(bv), 256)
    assert torch.equal(tdt.dot_scores_plain(_t(uv), packed), scores)
    assert torch.equal(tdt.dot_submax(_t(uv), packed, _t(mask)),
                       ttb.submax(scores, _t(mask), 256))
    ref = ttb.blockwise_candidates(scores, 12, 256, _t(mask))
    got = tdt.dot_topk_candidates(_t(uv), None, None, 12, _t(mask),
                                  packed=packed)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_pack_items_layout():
    items = torch.arange(5 * 6, dtype=torch.float32).reshape(5, 6)
    p = tdt.pack_items(items, None, 128)
    assert p.table.shape == (2, 128, 4) and (p.n, p.d) == (5, 6)
    assert torch.equal(p.table[1, 3, :2], items[3, 4:])
    assert torch.equal(p.table[0, 4], items[4, :4])
    assert bool((p.table[1, :, 2:] == 0).all() and (p.table[:, 5:] == 0).all())
    assert bool((p.bias[:5] == 0).all() and (p.bias[5:] == -np.inf).all())
    assert tdt.pack_items(items, torch.ones(5), 256).bias.shape == (256,)


def test_wrappers_refuse_bad_inputs():
    items = torch.zeros((300, 8))
    with pytest.raises(ValueError):
        tdt.pack_items(torch.zeros((10, tdt.MAX_DIM + 1)))
    with pytest.raises(ValueError):
        tdt.pack_items(items, torch.zeros(299))
    with pytest.raises(ValueError):
        tdt.pack_items(items, block_n=100)
    packed = tdt.pack_items(items, block_n=128)
    with pytest.raises(ValueError):
        tdt.dot_submax(torch.zeros((2, 7)), packed)         # d differs
    with pytest.raises(ValueError):
        tdt.dot_extract(torch.zeros((2, 8)), packed, torch.zeros(2), 129)
    with pytest.raises(ValueError):
        tdt.dot_extract(torch.zeros((2, 8)), packed, torch.zeros(3), 5)
    with pytest.raises(ValueError):
        ttb.rank_lookup_count(torch.zeros((2, 5)), torch.zeros(
            (2, 4), dtype=torch.int32), torch.zeros((2, 3), dtype=torch.int32))


def test_wrappers_on_a_cuda_tensor_never_reach_the_plain_versions(
        monkeypatch):
    """With the device check answering 'cuda', each wrapper launches its
    kernel with the padded operands and counts it; a failed launch raises
    instead of falling back."""
    def plain(*args, **kwargs):
        raise AssertionError("plain version reached")

    calls = []
    for mod, names in ((tdt, ("dot_submax_plain", "dot_extract_plain")),
                       (ttb, ("rank_lookup_count_plain",))):
        monkeypatch.setattr(mod, "_on_cuda", lambda *t: True)
        monkeypatch.setattr(mod, "_launch", lambda name, dev, *a: calls.append(
            (name, a)))
        for name in names:
            monkeypatch.setattr(mod, name, plain)
    packed = tdt.pack_items(torch.zeros((5000, 10)), block_n=4096)
    uv = torch.ones((3, 10))
    mask = torch.zeros((3, 7), dtype=torch.int32)
    runtime.reset_launches()
    tdt.dot_submax(uv, packed, mask)
    tdt.dot_extract(uv, packed, torch.zeros(3), 4, None)
    ttb.rank_lookup_count(torch.zeros((3, 8)), torch.zeros(
        (3, 8), dtype=torch.int32), torch.zeros((3, 2), dtype=torch.int32))
    assert [c[0] for c in calls] == ["skrx_dot_submax", "skrx_dot_extract",
                                     "skrx_rank_lookup_count"]
    sub, ext = calls[0][1], calls[1][1]
    assert sub[0].shape == (32, 12) and sub[1:3] == (3, 3)   # uv padded
    assert sub[3] is packed.table and sub[5:8] == (5000, 8192, 4096)
    assert sub[8] is mask and sub[9] == 7
    assert ext[8] is None and ext[9] == 0 and ext[11] == 4
    assert {k: runtime.LAUNCHES[k] for k in
            ("dot_submax", "dot_extract", "rank_lookup_count")} == {
        "dot_submax": 1, "dot_extract": 1, "rank_lookup_count": 1}

    def failed(name, dev, *a):
        raise RuntimeError(f"{name} launch failed: CUDA error 1")
    monkeypatch.setattr(tdt, "_launch", failed)
    with pytest.raises(RuntimeError, match="launch failed"):
        tdt.dot_submax(uv, packed)
