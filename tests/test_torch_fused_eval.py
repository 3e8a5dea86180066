"""The fused and chunked strategies end to end: the port's
``RankingEvaluator`` with eval_mode "fused" and "chunked" against the JAX
package's ``evaluate_fused`` (its Pallas kernels in interpret mode) and
``evaluate_chunked``, and fused serving against JAX's
``TopKRecommender(fused="always")``, for BPRMF and LightGCN on the same data
and weights (carried by ``convert.py``).

BPRMF gets dyadic weights (small integers over a power of two, d = 8): every
score is exact in f32 on every route, so metrics match within 1e-7 and
served ids and values exactly. LightGCN's propagated embeddings are not
dyadic, so its scores round differently in the two frameworks: metrics
within 1e-6, served values within 1e-5 and ids where the ranking is
separated by more than that."""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from skrx import RunConfig as JaxRunConfig
from skrx.eval import RankingEvaluator as JaxRankingEvaluator
from skrx.io import synthetic as jax_synthetic
from skrx.models.BPRMF import BPRMF as JaxBPRMF
from skrx.models.LightGCN import LightGCN as JaxLightGCN
from skrx.serve import TopKRecommender as JaxTopKRecommender
from skrx_torch import RunConfig
from skrx_torch.eval import RankingEvaluator, fused_family
from skrx_torch.models.BPRMF import BPRMF
from skrx_torch.models.CDAE import CDAE
from skrx_torch.models.CML import CML
from skrx_torch.models.LightGCN import LightGCN
from skrx_torch.models.common import CachedUserVecChunkMixin
from skrx_torch.ops.kernels import dot_topk as tdt
from skrx_torch.ops.kernels import runtime
from skrx_torch.serve import TopKRecommender

METRICS = ("Precision", "Recall", "MAP", "NDCG", "MRR")
RUN = dict(seed=1, metric=("NDCG", "Recall"), top_k=(5, 10),
           test_batch_size=16)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{name: (jax model, port model)} over one dataset, with one set of
    weights each."""
    root = tmp_path_factory.mktemp("torch_fused_eval")
    data = jax_synthetic.make_dataset_dir(str(root), num_users=70,
                                          num_items=130, num_ratings=1800,
                                          seed=6)
    rng = np.random.default_rng(12)
    cwd = os.getcwd()
    os.chdir(root)                         # the models write log/ here
    try:
        jb = JaxBPRMF(JaxRunConfig(recommender="BPRMF", data_dir=data, **RUN),
                      dict(n_dim=8))
        tb = BPRMF(RunConfig(data_dir=data, **RUN), dict(n_dim=8),
                   device="cpu")
        jg = JaxLightGCN(JaxRunConfig(recommender="LightGCN", data_dir=data,
                                      **RUN),
                         dict(embed_size=8, n_layers=2, graph_impl="segment"))
        tg = LightGCN(RunConfig(data_dir=data, **RUN),
                      dict(embed_size=8, n_layers=2), device="cpu")
    finally:
        os.chdir(cwd)
    dyadic = {"user_emb": rng.integers(-8, 9, (jb.num_users, 8)) / 4,
              "item_emb": rng.integers(-8, 9, (jb.num_items, 8)) / 8,
              "item_bias": rng.integers(-16, 17, jb.num_items) / 16}
    normal = {"user_emb": rng.standard_normal((jg.num_users, 8)),
              "item_emb": rng.standard_normal((jg.num_items, 8))}
    for jm, tm, params in ((jb, tb, dyadic), (jg, tg, normal)):
        params = {k: v.astype(np.float32) for k, v in params.items()}
        jm.params = {k: jnp.asarray(v) for k, v in params.items()}
        tm.load_jax_params(params)
    jg._final_emb = None
    return {"BPRMF": (jb, tb), "LightGCN": (jg, tg)}


def _evaluators(tm, mode, **kw):
    train = tm.dataset.train_data.to_user_dict()
    test = tm.dataset.test_data.to_user_dict()
    args = dict(metric=METRICS, top_k=(5, 10, 20), batch_size=16,
                eval_mode=mode, **kw)
    return (JaxRankingEvaluator(train, test, **args),
            RankingEvaluator(train, test, device="cpu", **args))


@pytest.mark.parametrize("name", ["BPRMF", "LightGCN"])
@pytest.mark.parametrize("mode", ["fused", "chunked"])
def test_fused_and_chunked_evaluate_match_jax(models, name, mode):
    """The port's evaluate() in the mode against JAX's evaluate() in the
    same mode (a chunk of 48 items: 3 chunks, the last of 34) and against
    the port's full route."""
    jm, tm = models[name]
    jev, tev = _evaluators(tm, mode, chunk_size=48)
    subset = list(range(0, tm.num_users, 2)) + [tm.num_users + 3]
    ref, got = jev.evaluate(jm, subset), tev.evaluate(tm, subset)
    assert list(got.metrics()) == list(ref.metrics())
    tol = 1e-7 if name == "BPRMF" else 1e-6
    np.testing.assert_allclose(list(got.values()), list(ref.values()),
                               rtol=0, atol=tol)
    full = _evaluators(tm, "full")[1].evaluate(tm, subset)
    np.testing.assert_allclose(list(got.values()), list(full.values()),
                               rtol=0, atol=tol)
    assert max(got.values()) > 0


@pytest.mark.parametrize("name", ["BPRMF", "LightGCN"])
def test_fused_serving_matches_jax(models, name):
    jm, tm = models[name]
    users = np.random.default_rng(3).integers(0, tm.num_users, 24)
    ref_ids, ref_vals = (np.asarray(x) for x in JaxTopKRecommender(
        jm, k=10, fused="always").recommend(users))
    server = TopKRecommender(tm, k=10, fused="always")
    assert server.fused
    ids, vals = server.recommend(users)
    assert ids.dtype == np.int32 and vals.dtype == np.float32
    seen = tm.dataset.train_data.to_user_dict()
    for u, row in zip(users, ids):
        assert not np.isin(row, seen.get(int(u), [])).any()
    if name == "BPRMF":
        np.testing.assert_array_equal(vals, ref_vals)
        np.testing.assert_array_equal(ids, ref_ids)
        return
    np.testing.assert_allclose(vals, ref_vals, rtol=1e-5, atol=1e-6)
    gap = np.abs(np.diff(ref_vals, axis=1)) > 1e-5
    sep = np.ones_like(ids, dtype=bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    assert sep.mean() > 0.9
    np.testing.assert_array_equal(ids[sep], ref_ids[sep])


def test_fused_serving_equals_the_score_matrix_route_and_launches_nothing_here(
        models):
    _, tm = models["BPRMF"]
    users = np.arange(tm.num_users)
    runtime.reset_launches()
    fused = TopKRecommender(tm, k=7, fused="always").recommend(users)
    plain = TopKRecommender(tm, k=7).recommend(users)
    for a, b in zip(fused, plain):
        np.testing.assert_array_equal(a, b)
    assert all(v == 0 for v in runtime.LAUNCHES.values())   # CPU: plain


def _serving_follows_training(tmp_path, monkeypatch, optimizer):
    monkeypatch.chdir(tmp_path)
    data = jax_synthetic.make_dataset_dir(str(tmp_path), num_users=40,
                                          num_items=150, num_ratings=900,
                                          seed=2)
    m = BPRMF(RunConfig(data_dir=data, seed=3, top_k=(10,),
                        metric=("NDCG",)),
              dict(n_dim=8, epochs=1, lr=0.05, optimizer=optimizer),
              device="cpu")
    server = TopKRecommender(m, k=10, fused="always")
    users = np.arange(40)
    server.recommend(users)
    before = server._packed_cache[2]
    m.fit()
    ids, vals = server.recommend(users)
    after = server._packed_cache[2]
    assert after is not before
    fresh = tdt.pack_items(m.item_emb, m.item_bias)
    assert torch.equal(after.table, fresh.table)
    assert torch.equal(after.bias, fresh.bias)
    ref_v, ref_i = tdt.dot_topk(m.user_emb.detach(), None, None, 10,
                                mask_table=server._seen, packed=fresh)
    np.testing.assert_array_equal(ids, ref_i.numpy())
    np.testing.assert_array_equal(vals, ref_v.numpy())
    server.recommend(users[:5])
    assert server._packed_cache[2] is after


def test_serving_cache_follows_training(tmp_path, monkeypatch):
    """BPRMF's item table is a live parameter that Adam updates in place:
    after fit() the fused route serves the new weights, packed once more,
    and serves from the cache while they stay."""
    _serving_follows_training(tmp_path, monkeypatch, "adam")


def test_serving_cache_follows_lazy_adam_training(tmp_path, monkeypatch):
    """The same with lazy Adam, which writes the touched rows in place: the
    step must move the table's version counter as dense Adam's does."""
    _serving_follows_training(tmp_path, monkeypatch, "lazy_adam")


def test_lightgcn_serving_follows_the_frozen_embeddings(models):
    _, tm = models["LightGCN"]
    server = TopKRecommender(tm, k=5, fused="always")
    tm._final_emb = None              # frozen on demand, inside recommend
    server.recommend([0, 1])
    first = server._packed_cache[2]
    server.recommend([2])
    assert server._packed_cache[2] is first
    tm.evaluate()                     # propagated again: new tensors
    server.recommend([2])
    assert server._packed_cache[2] is not first


def test_auto_takes_chunked_at_the_threshold(models, monkeypatch):
    _, tm = models["BPRMF"]
    seen = []
    for mode in ("chunked", "fused", "full"):
        monkeypatch.setattr(
            RankingEvaluator,
            "_evaluate_full" if mode == "full" else f"evaluate_{mode}",
            lambda self, *a, mode=mode: seen.append(mode))
    for threshold in (tm.num_items, tm.num_items + 1):
        _evaluators(tm, "auto", chunk_threshold=threshold)[1].evaluate(tm)
    _evaluators(tm, "fused")[1].evaluate(tm)
    assert seen == ["chunked", "full", "fused"]


def test_modes_refuse_models_without_the_factorization(models):
    class ScoresOnly:
        num_items = 130

        def predict(self, users):
            return torch.zeros((len(users), 130))
    _, tm = models["BPRMF"]
    for mode in ("fused", "chunked"):
        with pytest.raises(TypeError):
            _evaluators(tm, mode)[1].evaluate(ScoresOnly())
    server = TopKRecommender(tm, fused="auto")
    assert not server.fused
    assert 0 <= _evaluators(tm, "full")[1].evaluate(ScoresOnly())["NDCG@5"]


class _Tower(CachedUserVecChunkMixin):
    """A tower over BPRMF's tables: user vectors from an encoder,
    ``predict`` their dot with the item table plus the bias."""
    num_items = 130
    device = torch.device("cpu")

    def __init__(self, bprmf):
        self.bprmf = bprmf
        self.dataset = bprmf.dataset

    def _uv_state_refs(self):
        return tuple(self.bprmf.parameters())

    def _user_vectors(self, users):
        return torch.tanh(self.bprmf.user_emb[users])

    def _score_user_chunk(self, uv, lo, hi):
        return uv @ self.bprmf.item_emb[lo:hi].T + self.bprmf.item_bias[lo:hi]

    @torch.no_grad()
    def predict(self, users):
        return self.predict_chunk(users, 0, self.num_items)


class _FactoredTower(_Tower):
    def _topk_factors(self, uv):
        return uv, self.bprmf.item_emb, self.bprmf.item_bias


class _ScoreFnTower(_FactoredTower):
    @staticmethod
    def _topk_score_fn(uv, items, bias):
        return torch.relu(uv @ items.T + bias)


def test_fused_takes_tower_factors_and_refuses_towers_without_them(
        models, tmp_path, monkeypatch):
    """A tower with plain dot factors (_topk_factors) evaluates fused,
    equal to its full route; a tower without them, and one that applies a
    transform after the dot (_topk_score_fn), are refused by the fused
    route and by a model's construction with eval_mode "fused"; serving
    keeps every tower on predict."""
    _, tm = models["BPRMF"]
    tower = _FactoredTower(tm)
    assert fused_family(tower) == "tower" and fused_family(tm) == "dot"
    full = _evaluators(tm, "full")[1].evaluate(tower)
    fused = _evaluators(tm, "fused")[1].evaluate(tower)
    np.testing.assert_allclose(list(fused.values()), list(full.values()),
                               rtol=0, atol=1e-7)
    assert max(full.values()) > 0
    for model in (_Tower(tm), _ScoreFnTower(tm)):
        assert fused_family(model) is None
        with pytest.raises(TypeError, match="fused"):
            _evaluators(tm, "fused")[1].evaluate(model)
    assert not TopKRecommender(_FactoredTower(tm), fused="always").fused
    monkeypatch.chdir(tmp_path)            # the models write log/ here
    run = RunConfig(data_dir=tm.dataset.data_dir, eval_mode="fused")
    with pytest.raises(TypeError, match="fused"):
        CML(run, dict(embed_size=8), device="cpu")
    assert CDAE(run, dict(hidden_dim=8), device="cpu").evaluator.eval_mode \
        == "fused"
