"""The serving slice: the port's BPRMF + TopKRecommender against the JAX
package's on the same data and parameters (numpy-seeded N(0, 1) weights,
so scores are well separated)."""
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import torch

from skrx import RunConfig as JaxRunConfig
from skrx.io import synthetic as jax_synthetic
from skrx.models.BPRMF import BPRMF as JaxBPRMF
from skrx.serve import TopKRecommender as JaxTopKRecommender
from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.convert import bprmf_params_from_jax
from skrx_torch.models.BPRMF import BPRMF
from skrx_torch.serve import TopKRecommender


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(jax model, port model) over one dataset with one set of weights."""
    import jax.numpy as jnp
    root = tmp_path_factory.mktemp("torch_serve")
    data = jax_synthetic.make_dataset_dir(str(root), num_users=70,
                                          num_items=130, num_ratings=1800,
                                          seed=5)
    cwd = os.getcwd()
    os.chdir(root)                         # both models write log/ here
    try:
        jm = JaxBPRMF(JaxRunConfig(recommender="BPRMF", data_dir=data,
                                   seed=1, metric=("NDCG",), top_k=(10,)),
                      dict(n_dim=16))
        tm = BPRMF(RunConfig(data_dir=data, seed=1), dict(n_dim=16),
                   device="cpu")
    finally:
        os.chdir(cwd)
    rng = np.random.default_rng(11)
    jm.params = {
        "user_emb": jnp.asarray(rng.standard_normal(
            (jm.num_users, 16)).astype(np.float32)),
        "item_emb": jnp.asarray(rng.standard_normal(
            (jm.num_items, 16)).astype(np.float32)),
        "item_bias": jnp.asarray(rng.standard_normal(
            jm.num_items).astype(np.float32)),
    }
    tm.load_jax_params({k: np.asarray(v) for k, v in jm.params.items()})
    return jm, tm


def _assert_same_ranking(ids, vals, ref_ids, ref_vals):
    # XLA and torch CPU matmuls round differently: values to 1e-5, ids
    # wherever the JAX ranking is separated by more than that
    np.testing.assert_allclose(vals, ref_vals, rtol=1e-5, atol=1e-6)
    gap = np.abs(np.diff(ref_vals, axis=1)) > 1e-5
    sep = np.ones_like(ids, dtype=bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    assert sep.mean() > 0.9
    np.testing.assert_array_equal(ids[sep], ref_ids[sep])


def test_converted_params_and_predict_match_jax(pair):
    jm, tm = pair
    params = bprmf_params_from_jax({k: np.asarray(v)
                                    for k, v in jm.params.items()})
    for name, value in params.items():
        np.testing.assert_array_equal(getattr(tm, name).detach().numpy(),
                                      value.numpy())
    users = np.arange(jm.num_users)
    np.testing.assert_allclose(tm.predict(users).numpy(),
                               np.asarray(jm.predict(users)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.predict_chunk(users, 10, 50).numpy(),
                               np.asarray(jm.predict_chunk(users, 10, 50)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("filter_seen", [True, False])
def test_recommend_matches_jax(pair, filter_seen):
    jm, tm = pair
    users = np.random.default_rng(2).integers(0, jm.num_users, 32)
    ref_ids, ref_vals = JaxTopKRecommender(
        jm, k=10, filter_seen=filter_seen).recommend(users)
    ids, vals = TopKRecommender(tm, k=10,
                                filter_seen=filter_seen).recommend(users)
    assert ids.dtype == np.int32 and vals.dtype == np.float32
    assert ids.shape == vals.shape == (32, 10)
    _assert_same_ranking(ids, vals, np.asarray(ref_ids), np.asarray(ref_vals))
    if filter_seen:
        seen = tm.dataset.train_data.to_user_dict()
        for u, row in zip(users, ids):
            assert not np.isin(row, seen.get(int(u), [])).any()


def test_recommend_rejects_unknown_users(pair):
    _, tm = pair
    server = TopKRecommender(tm)
    for bad in ([0, tm.num_users], [-1]):
        with pytest.raises(ValueError):
            server.recommend(bad)


def test_fused_always_is_not_ported(pair):
    """fused="sometimes" is refused; under "always" a dot model takes the
    fused route, under "auto" and "never" the score-matrix route, and the
    two give the same top-k."""
    _, tm = pair
    with pytest.raises(ValueError):
        TopKRecommender(tm, fused="sometimes")
    users = np.arange(tm.num_users)
    server = TopKRecommender(tm, fused="always")
    assert server.fused
    assert not TopKRecommender(tm, fused="auto").fused
    assert not TopKRecommender(tm, fused="never").fused
    got, ref = server.recommend(users), TopKRecommender(tm).recommend(users)
    _assert_same_ranking(*got, *ref)


def test_registry_builds_bprmf_by_name(pair, tmp_path, monkeypatch):
    jm, _ = pair
    monkeypatch.chdir(tmp_path)            # the model writes log/ here
    reg = ModelRegistry()
    reg.load_skrx_model("BPRMF")
    cls, cfg_cls = reg.get_model("BPRMF")
    assert cls is BPRMF and cfg_cls().n_dim == 64
    assert reg.load_skrx_model("NoSuchModel") is False
    with pytest.raises(KeyError):
        reg.get_model("NoSuchModel")
    m = cls(RunConfig(data_dir=jm.dataset.data_dir, seed=4), {},
            device="cpu")
    assert m.user_emb.shape == (jm.num_users, 64)
    assert torch.all(m.item_bias == 0)
    std = float(m.item_emb.detach().std())
    assert 0.008 < std < 0.012            # normal(0.01) initializer


def test_load_jax_params_rejects_mismatched_shapes(pair):
    _, tm = pair
    bad = {"user_emb": np.zeros((3, 16), np.float32),
           "item_emb": np.zeros((tm.num_items, 16), np.float32),
           "item_bias": np.zeros(tm.num_items, np.float32)}
    with pytest.raises(ValueError):
        tm.load_jax_params(bad)
    with pytest.raises(ValueError):
        bprmf_params_from_jax({"user_emb": bad["user_emb"]})
