"""Pop, AOBPR and CML in the port against the JAX package's, on the same
numpy-seeded data and weights: ``predict`` within 1e-5 relative (Pop
exactly), Pop's ``evaluate()`` within 1e-6, CML's train step (loss,
parameters, Adagrad accumulators) within 1e-5, AOBPR's factor sort exactly
and its SGD step with the negatives held fixed within 1e-6, and ``fit()``
of AOBPR and CML in the two-sided parity band of JAX's ``fit()``."""
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from skrx import RunConfig as JaxRunConfig
from skrx.io import synthetic as jax_synthetic
from skrx.utils import ModelRegistry as JaxModelRegistry
from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.models import AOBPR as taobpr
from skrx_torch.models.CML import CML
from skrx_torch.models.common import CachedUserVecChunkMixin
from .parity_utils import assert_parity, run_seed

RUN = dict(metric=("NDCG", "Recall"), top_k=(5, 10), test_batch_size=32,
           seed=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Steps of a few small ops: one intra-op thread keeps them fast when
    the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def _pair(name, data, cfg, **run):
    """The JAX model and the port's (on the CPU), built by name from the
    same RunConfig fields."""
    fields = dict(RUN, data_dir=data, **run)
    jreg, treg = JaxModelRegistry(), ModelRegistry()
    jreg.load_skrx_model(name)
    treg.load_skrx_model(name)
    jm = jreg.get_model(name)[0](JaxRunConfig(recommender=name, **fields),
                                 dict(cfg))
    tm = treg.get_model(name)[0](RunConfig(recommender=name, **fields),
                                 dict(cfg), device="cpu")
    return jm, tm


def _weights(rng, u, n, d):
    return {"user_emb": rng.standard_normal((u, d)).astype(np.float32) / 3,
            "item_emb": rng.standard_normal((n, d)).astype(np.float32) / 3}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_pairwise")
    return jax_synthetic.make_dataset_dir(str(root), num_users=70,
                                          num_items=150, num_ratings=2000,
                                          seed=6)


@pytest.fixture(autouse=True)
def _workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)          # models write log/ here


def test_registry_finds_pop_aobpr_and_cml():
    reg = ModelRegistry()
    for name in ("Pop", "AOBPR", "CML"):
        reg.load_skrx_model(name)
        cls, cfg = reg.get_model(name)
        assert cls.__name__ == name and cfg.__name__ == name + "Config"
    assert reg.list_models() == ["AOBPR", "CML", "Pop"]


# ------------------------------------------------------------------- Pop

def test_pop_predict_and_evaluate_match_jax(data):
    """Every item's score is its count, so whole runs of items tie; ranks
    follow (score desc, id asc) on both sides."""
    jm, tm = _pair("Pop", data, {})
    users = np.array([0, 5, 5, 33])
    got = tm.predict(users)
    assert got.shape == (4, tm.num_items) and got.stride(0) == 0   # a view
    np.testing.assert_array_equal(got.numpy(), np.asarray(jm.predict(users)))
    assert len(np.unique(got[0].numpy())) < tm.num_items // 2       # ties
    for subset in (None, list(range(0, 70, 4))):
        ref, rep = jm.evaluate(subset), tm.evaluate(subset)
        np.testing.assert_allclose(list(rep.values()), list(ref.values()),
                                   rtol=0, atol=1e-6)
    best = tm.fit()
    assert [h["loss"] for h in tm.history] == [None]
    np.testing.assert_allclose(list(best.values()),
                               list(jm.fit().values()), rtol=0, atol=1e-6)


# ----------------------------------------------------------------- AOBPR

def test_aobpr_predict_and_routes_match_jax(data):
    jm, tm = _pair("AOBPR", data, dict(embed_size=8, batch_size=64))
    params = _weights(np.random.default_rng(1), tm.num_users, tm.num_items, 8)
    jm.params = {k: jnp.asarray(v) for k, v in params.items()}
    tm.load_jax_params(params)
    users = np.arange(0, 70, 3)
    np.testing.assert_allclose(tm.predict(users).numpy(),
                               np.asarray(jm.predict(users)), rtol=1e-5,
                               atol=1e-6)
    full = np.array(list(tm.evaluate().values()))
    np.testing.assert_allclose(full, list(jm.evaluate().values()), rtol=0,
                               atol=1e-6)
    ev = tm.evaluator
    for mode in ("fused", "chunked"):
        ev.eval_mode, ev.chunk_size = mode, 64
        np.testing.assert_allclose(list(tm.evaluate().values()), full,
                                   rtol=0, atol=1e-6)


def test_aobpr_factor_sort_matches_jax():
    rng = np.random.default_rng(2)
    emb = np.round(rng.standard_normal((90, 6)) * 2).astype(np.float32)
    emb[10:20, 1] = emb[5, 1]                        # ties within a factor
    order, std = taobpr.sort_factors(_t(emb))
    np.testing.assert_array_equal(order.numpy(),
                                  np.asarray(jnp.argsort(-jnp.asarray(emb),
                                                         axis=0)))
    np.testing.assert_allclose(std.numpy(),
                               np.asarray(jnp.std(jnp.asarray(emb), axis=0)),
                               rtol=1e-6)


def _jax_aobpr_sgd(params, users, pos, neg, w, lr, reg):
    """The update of one step of ``skrx/models/AOBPR.py`` once its
    negatives are drawn (its ``step``, from ``ue =`` to the loss)."""
    ue = params["user_emb"][users]
    ie = params["item_emb"][pos]
    je = params["item_emb"][neg]
    x_uij = jnp.sum(ue * (ie - je), -1)
    cmg = (jax.nn.sigmoid(-x_uij) * w)[:, None]
    du = lr * (cmg * (ie - je) - reg * ue * w[:, None])
    di = lr * (cmg * ue - reg * ie * w[:, None])
    dj = lr * (-cmg * ue - reg * je * w[:, None])
    params = {"user_emb": params["user_emb"].at[users].add(du),
              "item_emb": params["item_emb"].at[pos].add(di).at[neg].add(dj)}
    return params, jnp.sum(-jax.nn.log_sigmoid(x_uij) * w)


def test_aobpr_step_with_fixed_negatives_matches_jax(data):
    """Repeated users and items in the batch (their deltas sum), padded
    rows of weight 0."""
    _, tm = _pair("AOBPR", data, dict(embed_size=8, batch_size=64,
                                      lr=0.05))
    rng = np.random.default_rng(3)
    params = _weights(rng, tm.num_users, tm.num_items, 8)
    tm.load_jax_params(params)
    b = 64
    users = rng.integers(0, 20, b)
    pos, neg = rng.integers(0, 40, b), rng.integers(0, 40, b)
    w = (np.arange(b) < 57).astype(np.float32)
    ref, ref_loss = _jax_aobpr_sgd(
        {k: jnp.asarray(v) for k, v in params.items()},
        *(jnp.asarray(x) for x in (users, pos, neg, w)), 0.05, 5e-2)
    loss = tm._sgd_step(*(_t(x) for x in (users, pos, neg, w)))
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    for key in params:
        np.testing.assert_allclose(getattr(tm, key).numpy(),
                                   np.asarray(ref[key]), rtol=1e-6,
                                   atol=1e-7)


def test_aobpr_negatives_follow_the_drawn_factor(data, monkeypatch):
    """A user vector with one nonzero factor always draws it: rank r gives
    the r-th item of the factor's order (from the other end for a negative
    factor); an all-zero row draws a factor without failing. An epoch sorts
    at its start and every resort_every steps after, never again at 0."""
    _, tm = _pair("AOBPR", data, dict(embed_size=8, batch_size=16))
    emb = tm.user_emb.data
    emb.zero_()
    emb[0, 3], emb[1, 5] = 0.7, -0.4
    order, std = taobpr.sort_factors(tm.item_emb)
    gen = torch.Generator().manual_seed(0)
    users = torch.tensor([0, 0, 1, 1, 2])
    ranks = torch.tensor([0, 4, 0, 4, 7])
    neg = tm._negatives(gen, users, ranks, order, std)
    n = tm.num_items
    assert neg[:4].tolist() == [order[0, 3], order[4, 3], order[n - 1, 5],
                                order[n - 5, 5]]
    assert 0 <= int(neg[4]) < n
    calls, sort = [], taobpr.sort_factors

    def counting(item_emb):
        calls.append(1)
        return sort(item_emb)
    monkeypatch.setattr(taobpr, "sort_factors", counting)
    tm.resort_every = 7
    tm._train_epoch(0)
    assert len(calls) == 1 + (tm.num_batches - 1) // 7


def test_aobpr_fit_lands_in_the_parity_band_of_jax_fit(tmp_path):
    """AOBPR fit() against JAX's from JAX's weights (convert.py); the
    permutation, ranks and factors come from different random streams.
    Over five seeds at this size the NDCG@10 ratio was 0.93-1.11 and the
    Recall@10 ratio 0.99-1.10, so SKRX_PARITY_SEED 0, 1 and 2 pass."""
    _fit_parity("AOBPR", tmp_path, dict(embed_size=16, batch_size=256,
                                        epochs=10, early_stop=10, lr=0.05))


def _fit_parity(name, tmp_path, cfg):
    data = jax_synthetic.make_dataset_dir(str(tmp_path), num_users=600,
                                          num_items=400, num_ratings=18000,
                                          seed=13, latent_dim=4,
                                          latent_strength=8.0)
    jm, tm = _pair(name, data, cfg, top_k=(10,), test_batch_size=64,
                   seed=run_seed())
    tm.load_jax_params({k: np.asarray(v) for k, v in jm.params.items()})
    ref, got = jm.fit(), tm.fit()
    assert_parity(f"{name.lower()}_torch", got, ref)
    losses = [h["loss"] for h in tm.history]
    assert len(losses) == cfg["epochs"] and losses[-1] < losses[0]


# ------------------------------------------------------------------- CML

def test_cml_predict_and_chunks_match_jax(data):
    jm, tm = _pair("CML", data, dict(embed_size=8))
    params = _weights(np.random.default_rng(4), tm.num_users, tm.num_items, 8)
    jm.params = {k: jnp.asarray(v) for k, v in params.items()}
    tm.load_jax_params(params)
    users = np.arange(0, 70, 3)
    got = tm.predict(users)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.predict(users)),
                               rtol=1e-5, atol=1e-6)
    chunk = tm.predict_chunk(users, 40, 95)
    assert torch.equal(chunk, got[:, 40:95])
    np.testing.assert_allclose(
        chunk.numpy(), np.asarray(jm.predict_chunk(users, 40, 95)),
        rtol=1e-5, atol=1e-6)
    full = list(tm.evaluate().values())
    np.testing.assert_allclose(full, list(jm.evaluate().values()), rtol=0,
                               atol=1e-5)
    tm.evaluator.eval_mode, tm.evaluator.chunk_size = "chunked", 64
    np.testing.assert_allclose(list(tm.evaluate().values()), full, rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError, match="model axis is above 1"):
        tm.predict_topk(users, 5)           # JAX asserts a model axis
    # the mixin's cached route scores the same chunks; the user vectors
    # are taken once per (state, users)
    cached = _cached_cml(data)
    cached.load_jax_params(params)
    assert torch.equal(cached.predict_chunk(users, 40, 95), chunk)
    uv = cached._uv_cache[2]
    cached.predict_chunk(users, 0, 10)
    assert cached._uv_cache[2] is uv
    with torch.no_grad():
        cached.user_emb.mul_(2.0)                 # an in-place update
    cached.predict_chunk(users, 0, 10)
    assert cached._uv_cache[2] is not uv


class _CachedCML(CML):
    """CML scored through ``CachedUserVecChunkMixin``'s cached user vectors,
    as a model with an expensive user encoder is (CML itself scores a
    chunk straight from its user rows, as in the JAX package)."""
    predict_chunk = CachedUserVecChunkMixin.predict_chunk

    def _score_user_chunk(self, uv, item_lo, item_hi):
        return self._topk_score_fn(uv, self.item_emb[item_lo:item_hi], None)


def _cached_cml(data, **cfg):
    return _CachedCML(RunConfig(recommender="CML", data_dir=data, **RUN),
                      dict(embed_size=8, **cfg), device="cpu")


def test_cml_refuses_the_fused_route(data):
    treg = ModelRegistry()
    treg.load_skrx_model("CML")
    with pytest.raises(TypeError, match="fused"):
        treg.get_model("CML")[0](RunConfig(data_dir=data, eval_mode="fused"),
                                 {}, device="cpu")


def test_cml_train_step_matches_jax(data):
    """JAX's parameters and Adagrad accumulators (converted), then three
    fixed batches (repeated rows, padding of weight 0): loss, parameters
    after the clip and accumulators agree."""
    cfg = dict(embed_size=8, dns=4, batch_size=32)
    jm, tm = _pair("CML", data, cfg)
    rng = np.random.default_rng(5)
    params = _weights(rng, tm.num_users, tm.num_items, 8)
    params["user_emb"][:3] *= 6                       # rows above clip_norm
    acc = {k: rng.uniform(0.1, 2.0, v.shape).astype(np.float32)
           for k, v in params.items()}
    rss, rest = jm.opt_state[0], jm.opt_state[1:]
    carry = ({k: jnp.asarray(v) for k, v in params.items()},
             (rss._replace(sum_of_squares={k: jnp.asarray(v) for k, v
                                           in acc.items()}), *rest))
    tm.load_jax_params(params)
    tm.load_jax_opt_state(acc)
    step = jax.jit(jm._train_step)
    for _ in range(3):
        b = 32
        batch = (rng.integers(0, 20, b), rng.integers(0, 60, b),
                 rng.integers(0, tm.num_items, (b, 4)),
                 (np.arange(b) < 29).astype(np.float32))
        carry, ref_loss = step(carry, (
            *(jnp.asarray(x.astype(np.int32)) for x in batch[:3]),
            jnp.asarray(batch[3])))
        loss = tm.train_step(tuple(_t(x) for x in batch))
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    for key in params:
        np.testing.assert_allclose(getattr(tm, key).detach().numpy(),
                                   np.asarray(carry[0][key]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(
            tm.optimizer.state[getattr(tm, key)]["sum_of_squares"].numpy(),
            np.asarray(carry[1][0].sum_of_squares[key]), rtol=1e-5)
    assert float(torch.linalg.vector_norm(tm.user_emb.detach()[:3],
                                          dim=1).max()) <= 1.0 + 1e-6


def test_cml_fit_lands_in_the_parity_band_of_jax_fit(tmp_path):
    """As AOBPR's: over five seeds the NDCG@10 ratio was 0.96-1.04 and the
    Recall@10 ratio 0.95-1.03. fit() clears the cached user vectors after
    each epoch."""
    _fit_parity("CML", tmp_path, dict(embed_size=16, batch_size=256,
                                      epochs=10, early_stop=10, dns=5))


def test_fit_clears_predict_caches(data):
    tm = _cached_cml(data, epochs=1)
    tm.predict_chunk([0, 1], 0, 5)
    assert tm._uv_cache is not None
    tm.fit()
    assert tm._uv_cache is None
    assert math.isfinite(tm.history[0]["loss"])
