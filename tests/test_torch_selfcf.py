"""SelfCF in the port against the JAX package's, on the same data, weights,
Adam state and batch. JAX runs ``graph_impl="segment"``. The adjacency; one
train step with JAX's own draws (the rate, edge mask and target dropout
masks rebuilt from the step's key and passed in), dropout on and off, loss
and every parameter within rtol 1e-5 / atol 1e-6; the draws' contract;
predict within rtol 1e-5 and evaluate() within 1e-6 of JAX's, the fused
and chunked routes equal to the full one; config, registry, converter,
fit() with checkpoint and resume."""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from skrx import RunConfig as JaxRunConfig
from skrx.io import synthetic as jax_synthetic
from skrx.models.SelfCF import SelfCF as JaxSelfCF
from skrx.models.SelfCF import SelfCFConfig as JaxSelfCFConfig
from skrx.models.SelfCF import _norm_adj_eps
from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.convert import selfcf_params_from_jax
from skrx_torch.models.SelfCF import (SelfCF, SelfCFConfig, selfcf_draws,
                                      selfcf_norm_adj)
from skrx_torch.models.pipeline import epoch_generator

DIM = 8
CFG = dict(embed_dim=DIM, n_layers=2, lr=0.01, reg=0.01, batch_size=32)
TOL = dict(rtol=1e-5, atol=1e-6)
RUN = dict(seed=1, metric=("NDCG", "Recall"), top_k=(5, 10),
           test_batch_size=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def build(tmp_path_factory):
    """(jax model, port model) for config overrides, built once each."""
    root = tmp_path_factory.mktemp("torch_selfcf")
    data = jax_synthetic.make_dataset_dir(str(root), num_users=60,
                                          num_items=90, num_ratings=1400,
                                          seed=6)
    cache = {}

    def make(**over):
        key = tuple(sorted(over.items()))
        if key not in cache:
            cwd = os.getcwd()
            os.chdir(root)                 # the models write log/ here
            try:
                cfg = dict(CFG, **over)
                jm = JaxSelfCF(JaxRunConfig(recommender="SelfCF",
                                            data_dir=data, **RUN),
                               dict(cfg, graph_impl="segment"))
                tm = SelfCF(RunConfig(data_dir=data, **RUN), cfg,
                            device="cpu")
            finally:
                os.chdir(cwd)
            cache[key] = (jm, tm)
        return cache[key]
    return make


def _set_weights(jm, tm, rng, scale=0.3):
    def mat(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    params = {"user_emb": mat(jm.num_users, DIM),
              "item_emb": mat(jm.num_items, DIM),
              "pred_w": mat(DIM, DIM), "pred_b": mat(DIM)}
    jm.params = jax.tree_util.tree_map(jnp.asarray, params)
    jm._final = None
    tm.load_jax_params(params)
    return params


def test_adjacency_matches_jax(build):
    jm, tm = build()
    pairs = tm.dataset.train_data.to_user_item_pairs()
    got = selfcf_norm_adj(pairs, tm.num_users, tm.num_items)
    ref = _norm_adj_eps(jm.dataset.train_data.to_user_item_pairs(),
                        jm.num_users, jm.num_items)
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_array_equal(got.data, ref.data)
    assert tm.graph.num_edges == got.nnz == 2 * len(pairs)


def _jax_draws(key, num_edges, batch, dropout):
    """The draws of JAX's step with ``key``, rebuilt: the step splits the
    carry's key, then its loss splits the subkey into k_rate, k_edge, k_u
    and k_i."""
    _, sub = jax.random.split(key)
    k_rate, k_edge, k_u, k_i = jax.random.split(sub, 4)
    rate = jax.random.uniform(k_rate)
    keep = jax.random.uniform(k_edge, (num_edges,)) >= rate
    edge_mask = keep.astype(jnp.float32) / jnp.maximum(1.0 - rate, 1e-8)
    masks = [None, None]
    if dropout > 0:
        masks = [jax.random.bernoulli(k, 1 - dropout, (batch, DIM))
                 for k in (k_u, k_i)]
    return float(rate), tuple(None if x is None else torch.from_numpy(
        np.array(x)) for x in (edge_mask, *masks))


@pytest.mark.parametrize("dropout", [0.5, 0.0])
def test_train_step_matches_jax(build, dropout):
    """Same params and Adam state (count 3, JAX's moments converted), the
    same batch and JAX's draws: the loss and every parameter after one step
    agree."""
    from jax.flatten_util import ravel_pytree
    jm, tm = build(dropout=dropout)
    rng = np.random.default_rng(11)
    params = _set_weights(jm, tm, rng)
    flat, unravel = ravel_pytree(jm.params)
    mu = rng.standard_normal(flat.shape[0]).astype(np.float32) * 0.05
    nu = rng.uniform(1e-3, 1e-2, flat.shape[0]).astype(np.float32)
    adam, *rest = jm.opt_state
    opt = (adam._replace(count=jnp.asarray(3, jnp.int32), mu=unravel(mu),
                         nu=unravel(nu)), *rest)
    tm.load_jax_opt_state(3, mu, nu)
    b = 32
    batch = (rng.integers(0, jm.num_users, b), rng.integers(0, jm.num_items, b),
             (rng.random(b) < 0.9).astype(np.float32))
    key = jax.random.key(5)
    carry, ref_loss = jm._step_with_key(
        (jm.params, opt, key),
        tuple(jnp.asarray(x.astype(np.int32) if x.dtype != np.float32 else x)
              for x in batch))
    rate, draws = _jax_draws(key, tm.graph.num_edges, b, dropout)
    assert 0 <= rate < 1
    loss = tm.train_step((*(torch.from_numpy(x) for x in batch), draws))
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    ref = selfcf_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                        carry[0]))
    got = dict(tm.named_parameters())
    assert set(got) == set(ref)
    start = selfcf_params_from_jax(params)
    for name, value in ref.items():
        np.testing.assert_allclose(got[name].detach().numpy(), value.numpy(),
                                   **TOL, err_msg=name)
        assert not np.allclose(value.numpy(), start[name].numpy()), name


def test_draws_contract(build):
    """rate ~ U[0, 1) first; kept edges (u >= rate) scaled by exactly 1 / (1
    - rate) in f32, the others 0; (B, d) keep masks at 1 - dropout; a new
    mask each step of an epoch, from stream 1 of (seed + 1, epoch)."""
    _, tm = build()
    e = tm.graph.num_edges
    gen = torch.Generator().manual_seed(3)
    rates = []
    for _ in range(40):
        replay = torch.Generator().set_state(gen.get_state())
        edge, mask_u, mask_i = selfcf_draws(gen, e, 16, DIM, 0.5)
        rate = torch.rand((), generator=replay)
        keep = torch.rand(e, generator=replay) >= rate
        assert torch.equal(edge != 0, keep)
        assert torch.equal(edge[keep], torch.full((int(keep.sum()),),
                                                  1.0) / (1.0 - rate))
        assert mask_u.shape == mask_i.shape == (16, DIM)
        assert mask_u.dtype == torch.bool and not torch.equal(mask_u, mask_i)
        rates.append(float(rate))
    assert 0 <= min(rates) and max(rates) < 1 and max(rates) > 0.5
    assert selfcf_draws(gen, e, 16, DIM, 0.0)[1:] == (None, None)
    drawn = []
    real = tm.step_draws
    tm.step_draws = lambda batch: drawn.append(real(batch)) or drawn[-1]
    try:
        tm._train_epoch(4)
    finally:
        del tm.step_draws
    assert len(drawn) == tm.pipeline.num_batches >= 2
    assert not torch.equal(drawn[0][0], drawn[1][0])
    want = selfcf_draws(epoch_generator(2, 4, torch.device("cpu"), stream=1),
                        e, CFG["batch_size"], DIM, 0.5)
    for got, ref in zip(drawn[0], want):
        assert torch.equal(got, ref)


def test_predict_and_evaluate_match_jax(build):
    jm, tm = build()
    _set_weights(jm, tm, np.random.default_rng(8), 1.0)
    users = np.arange(jm.num_users)
    np.testing.assert_allclose(tm.predict(users).numpy(),
                               np.asarray(jm.predict(users)), rtol=1e-5,
                               atol=1e-5)
    ref, got = jm.evaluate(), tm.evaluate()
    assert list(got.metrics()) == list(ref.metrics())
    np.testing.assert_allclose(list(got.values()), list(ref.values()),
                               rtol=0, atol=1e-6)
    u_all, i_all = tm._chunk_embeddings()
    assert u_all.shape == (tm.num_users, 2 * DIM) and \
        i_all.shape == (tm.num_items, 2 * DIM)
    ev = tm.evaluator
    for mode in ("fused", "chunked"):
        ev.eval_mode, ev.chunk_size = mode, 32
        try:
            np.testing.assert_allclose(list(tm.evaluate().values()),
                                       list(got.values()), rtol=0, atol=1e-6)
        finally:
            ev.eval_mode = "full"


def test_config_registry_converter_and_fit(build, tmp_path, monkeypatch):
    _, tm = build()
    reg = ModelRegistry()
    reg.load_skrx_model("SelfCF")
    cls, cfg_cls = reg.get_model("SelfCF")
    assert cls is SelfCF and cfg_cls is SelfCFConfig
    defaults, ref = SelfCFConfig(), JaxSelfCFConfig()
    for field in defaults.to_dict():
        assert getattr(defaults, field) == getattr(ref, field), field
    assert SelfCFConfig.param_space() == JaxSelfCFConfig.param_space()
    for bad in (dict(dropout=1.0), dict(n_layers=0), dict(reg=-1.0),
                dict(graph_impl="dense"), dict(lr=1)):
        with pytest.raises(ValueError):
            SelfCFConfig(**bad)
    with pytest.raises(ValueError):
        selfcf_params_from_jax({"user_emb": np.zeros((3, 4)),
                                "item_emb": np.zeros((5, 4)),
                                "pred_w": np.zeros((4, 3)),
                                "pred_b": np.zeros(4)})
    monkeypatch.chdir(tmp_path)
    if not torch.cuda.is_available():      # the default device is CUDA
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(RunConfig(data_dir=tm.dataset.data_dir), dict(CFG))
    run = dict(data_dir=tm.dataset.data_dir, seed=1, top_k=(10,),
               checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1)
    m = cls(RunConfig(**run), dict(CFG, epochs=2), device="cpu")
    m.fit()
    losses = [h["loss"] for h in m.history]
    assert len(losses) == 2 and all(np.isfinite(losses))
    resumed = cls(RunConfig(**run, resume=True), dict(CFG, epochs=3),
                  device="cpu")
    state = {}
    first = resumed._train_epoch

    def snapshot(epoch):
        state.update({k: v.detach().clone()
                      for k, v in resumed.named_parameters()})
        return first(epoch)
    resumed._train_epoch = snapshot
    resumed.fit()
    assert [h["epoch"] for h in resumed.history] == [2]
    for name, value in m.named_parameters():
        assert torch.equal(state[name], value.detach()), name
