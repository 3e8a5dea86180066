"""The LightGCN slice: the port's LightGCN (train step, predict,
evaluate(), fit()) against the JAX package's on the same data and weights.
JAX runs ``graph_impl="segment"`` here for speed; the propagation itself is
held to JAX's kernel by tests/test_torch_graph.py."""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from skrx import RunConfig as JaxRunConfig
from skrx.io import synthetic as jax_synthetic
from skrx.models.LightGCN import LightGCN as JaxLightGCN
from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.convert import adam_state_from_jax, two_tables_from_jax
from skrx_torch.models.LightGCN import LightGCN, LightGCNConfig
from skrx_torch.ops.kernels import runtime
from .parity_utils import assert_parity, run_seed

CFG = dict(embed_size=8, n_layers=2, lr=0.01, reg=0.05, batch_size=32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(jax model, port model) over one small dataset; each test gives both
    the same weights."""
    root = tmp_path_factory.mktemp("torch_lightgcn")
    data = jax_synthetic.make_dataset_dir(str(root), num_users=60,
                                          num_items=90, num_ratings=1400,
                                          seed=4)
    cwd = os.getcwd()
    os.chdir(root)                         # both models write log/ here
    try:
        run = dict(data_dir=data, seed=1, metric=("NDCG", "Recall"),
                   top_k=(5, 10), test_batch_size=16)
        jm = JaxLightGCN(JaxRunConfig(recommender="LightGCN", **run),
                         dict(CFG, graph_impl="segment"))
        tm = LightGCN(RunConfig(**run), dict(CFG), device="cpu")
    finally:
        os.chdir(cwd)
    return jm, tm


def _set_weights(jm, tm, rng, scale):
    params = {"user_emb": rng.standard_normal((jm.num_users, 8)) * scale,
              "item_emb": rng.standard_normal((jm.num_items, 8)) * scale}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    jm.params = {k: jnp.asarray(v) for k, v in params.items()}
    jm._final_emb = None
    tm.load_jax_params(params)
    return params


def test_train_step_matches_jax(pair):
    """Same params and Adam state in both, then three fixed batches: the
    loss of each step and the parameters after it agree within 1e-5."""
    from jax.flatten_util import ravel_pytree
    jm, tm = pair
    rng = np.random.default_rng(4)
    params = _set_weights(jm, tm, rng, 0.3)
    flat, unravel = ravel_pytree(jm.params)
    mu = rng.standard_normal(flat.shape[0]).astype(np.float32) * 0.05
    nu = rng.uniform(1e-3, 1e-2, flat.shape[0]).astype(np.float32)
    adam, *rest = jm.optimizer.init(flat)
    carry = (flat, (adam._replace(count=jnp.asarray(4, jnp.int32),
                                  mu=jnp.asarray(mu), nu=jnp.asarray(nu)),
                    *rest))
    tm.load_jax_opt_state(4, mu, nu)
    step = jax.jit(jm._train_step)
    u, n, b = jm.num_users, jm.num_items, 32
    for _ in range(3):
        batch = (rng.integers(0, u, b).astype(np.int32),
                 rng.integers(0, n, b).astype(np.int32),
                 rng.integers(0, n, (b, 1)).astype(np.int32),
                 (rng.random(b) < 0.9).astype(np.float32))
        carry, ref_loss = step(carry, tuple(map(jnp.asarray, batch)))
        loss = tm.train_step(tuple(_t(x.astype(np.int64)) if x.dtype ==
                                   np.int32 else _t(x) for x in batch))
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
        ref = unravel(carry[0])
        for key in params:
            np.testing.assert_allclose(getattr(tm, key).detach().numpy(),
                                       np.asarray(ref[key]), rtol=1e-5,
                                       atol=1e-6)


def test_predict_and_evaluate_match_jax(pair):
    jm, tm = pair
    _set_weights(jm, tm, np.random.default_rng(8), 1.0)
    users = np.arange(jm.num_users)
    np.testing.assert_allclose(tm.predict(users).numpy(),
                               np.asarray(jm.predict(users)), rtol=1e-5,
                               atol=1e-5)
    ref, got = jm.evaluate(), tm.evaluate()
    assert list(got.metrics()) == list(ref.metrics())
    np.testing.assert_allclose(list(got.values()), list(ref.values()),
                               rtol=1e-6, atol=1e-7)


def test_frozen_embeddings_are_kept_until_the_next_epoch(pair):
    """evaluate() propagates once; predict and _chunk_embeddings reuse the
    same tensors until a training epoch moves the parameters."""
    _, tm = pair
    runtime.reset_launches()
    tm.evaluate()
    frozen = tm._chunk_embeddings()
    assert all(a is b for a, b in zip(frozen, tm._chunk_embeddings()))
    tm.predict([0, 1])
    assert all(a is b for a, b in zip(frozen, tm._final_emb))
    tm._train_epoch(0)
    moved = tm._chunk_embeddings()
    assert not torch.equal(moved[0], frozen[0])
    chunk = tm.predict_chunk([0, 1, 2], 10, 30)
    np.testing.assert_allclose(chunk.numpy(),
                               tm.predict([0, 1, 2])[:, 10:30].numpy(),
                               rtol=1e-6)
    assert all(v == 0 for v in runtime.LAUNCHES.values())   # CPU: plain


def test_registry_config_and_adjacency_cache(pair, tmp_path, monkeypatch):
    jm, tm = pair
    reg = ModelRegistry()
    reg.load_skrx_model("LightGCN")
    cls, cfg_cls = reg.get_model("LightGCN")
    assert cls is LightGCN and cfg_cls is LightGCNConfig
    defaults = LightGCNConfig()
    assert (defaults.embed_size, defaults.n_layers, defaults.adj_type,
            defaults.batch_size, defaults.lr, defaults.reg) == \
        (64, 3, "pre", 1024, 1e-3, 1e-3)
    for bad in (dict(adj_type="sym"), dict(graph_impl="pallas"),
                dict(n_layers=0), dict(lr=1)):
        with pytest.raises(ValueError):
            LightGCNConfig(**bad)
    cache = os.path.join(tm.dataset.data_dir, "_LightGCN_data",
                         "pre_adj.npz")
    assert os.path.exists(cache)
    assert tm.graph.num_nodes == jm.num_users + jm.num_items
    monkeypatch.chdir(tmp_path)
    again = cls(RunConfig(data_dir=tm.dataset.data_dir, seed=1), dict(CFG),
                device="cpu")
    np.testing.assert_array_equal(again.graph.fwd.weight.numpy(),
                                  tm.graph.fwd.weight.numpy())
    bf = cls(RunConfig(data_dir=tm.dataset.data_dir, seed=1),
             dict(CFG, graph_impl="mxu_bf16", adj_type="norm"), device="cpu")
    assert bf.graph.msg_dtype == torch.bfloat16
    assert bf.graph.num_edges == tm.graph.num_edges + tm.graph.num_nodes


def test_adam_state_conversion_follows_lightgcn_ravel_order():
    from jax.flatten_util import ravel_pytree
    rng = np.random.default_rng(1)
    tree = {"user_emb": rng.standard_normal((3, 2)).astype(np.float32),
            "item_emb": rng.standard_normal((5, 2)).astype(np.float32)}
    flat, _ = ravel_pytree({k: jnp.asarray(v) for k, v in tree.items()})
    np.testing.assert_array_equal(np.asarray(flat)[:10],
                                  tree["item_emb"].ravel())
    shapes = {k: v.shape for k, v in tree.items()}
    state = adam_state_from_jax(3, np.asarray(flat), -np.asarray(flat),
                                shapes)
    for key, value in tree.items():
        np.testing.assert_array_equal(state[key]["exp_avg"].numpy(), value)
        np.testing.assert_array_equal(state[key]["exp_avg_sq"].numpy(),
                                      -value)
        assert float(state[key]["step"]) == 3.0
    assert set(two_tables_from_jax(tree)) == set(tree)
    with pytest.raises(ValueError):
        two_tables_from_jax(dict(tree, item_bias=np.zeros(5)))
    with pytest.raises(ValueError):
        two_tables_from_jax(dict(tree, item_emb=np.zeros((5, 3))))


def test_fit_lands_in_the_parity_band_of_jax_fit(tmp_path, monkeypatch):
    """LightGCN fit() against the JAX package's, both built by name with
    the same RunConfig and started from the same weights (JAX's, carried
    over with convert.py); the negatives and the order of steps come from
    different random streams. Best NDCG@10 and Recall@10 land in the
    two-sided band: under SKRX_PARITY_SEED 0-3 the NDCG ratio is 0.95-1.03
    and the Recall ratio 0.93-1.04."""
    from skrx.utils import ModelRegistry as JaxModelRegistry
    monkeypatch.chdir(tmp_path)
    data = jax_synthetic.make_dataset_dir(str(tmp_path), num_users=300,
                                          num_items=200, num_ratings=7000,
                                          seed=13, latent_dim=4,
                                          latent_strength=8.0)
    cfg = dict(lr=0.01, reg=0.001, embed_size=16, n_layers=2,
               batch_size=256, epochs=8, early_stop=8)
    run = dict(recommender="LightGCN", data_dir=data, file_column="UIRT",
               sep="\t", metric=("NDCG", "Recall"), top_k=(10,),
               test_batch_size=64, seed=run_seed())
    jreg, treg = JaxModelRegistry(), ModelRegistry()
    jreg.load_skrx_model("LightGCN")
    treg.load_skrx_model("LightGCN")
    jm = jreg.get_model("LightGCN")[0](JaxRunConfig(**run),
                                       dict(cfg, graph_impl="segment"))
    model = treg.get_model("LightGCN")[0](RunConfig(**run), dict(cfg),
                                          device="cpu")
    model.load_jax_params({k: np.asarray(v) for k, v in jm.params.items()})
    ref, got = jm.fit(), model.fit()
    assert_parity("lightgcn_torch", got, ref)
    losses = [h["loss"] for h in model.history]
    assert len(losses) == 8 and losses[-1] < losses[0]
