"""LayerGCN in the port against the JAX package's, on the same data and
weights. JAX runs ``graph_impl="segment"``, which rebuilds the pruned edge
list each epoch; the port propagates over one static graph under an edge
mask. Forward, gradient, train step, predict and evaluate() within rtol
1e-5 / atol 1e-6 (metrics within 1e-6); the pruning contract on its own."""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from skrx import RunConfig as JaxRunConfig
from skrx.io import synthetic as jax_synthetic
from skrx.models.LayerGCN import LayerGCN as JaxLayerGCN
from skrx.models.LayerGCN import LayerGCNConfig as JaxLayerGCNConfig
from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.models.LayerGCN import (LayerGCN, LayerGCNConfig,
                                        layergcn_embeddings, layergcn_keep,
                                        layergcn_mask_from_keep)
from skrx_torch.models.common import make_train_step
from skrx_torch.models.pipeline import epoch_generator

DIM = 8
CFG = dict(embed_dim=DIM, n_layers=2, lr=0.01, reg=0.05, batch_size=32,
           dropout=0.3)
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(jax model, port model) over one small dataset; each test gives both
    the same weights."""
    root = tmp_path_factory.mktemp("torch_layergcn")
    data = jax_synthetic.make_dataset_dir(str(root), num_users=60,
                                          num_items=90, num_ratings=1400,
                                          seed=4)
    cwd = os.getcwd()
    os.chdir(root)                         # both models write log/ here
    try:
        run = dict(data_dir=data, seed=1, metric=("NDCG", "Recall"),
                   top_k=(5, 10), test_batch_size=16)
        jm = JaxLayerGCN(JaxRunConfig(recommender="LayerGCN", **run),
                         dict(CFG, graph_impl="segment"))
        tm = LayerGCN(RunConfig(**run), dict(CFG), device="cpu")
    finally:
        os.chdir(cwd)
    return jm, tm


def _set_weights(jm, tm, rng, scale=0.5):
    params = {"user_emb": rng.standard_normal((jm.num_users, DIM)) * scale,
              "item_emb": rng.standard_normal((jm.num_items, DIM)) * scale}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    jm.params = {k: jnp.asarray(v) for k, v in params.items()}
    jm._final_emb = None
    tm.load_jax_params(params)
    return params


def _isolating_key(jm, tm):
    """A key whose random pruning leaves some node with no kept edge, and
    that node; the kept pair ids as JAX's ``_pruned_random`` draws them."""
    pairs = tm.dataset.train_data.to_user_item_pairs()
    base = jax.random.key(7)
    for i in range(200):
        key = jax.random.fold_in(base, i)
        keep = np.asarray(jax.random.permutation(key, tm.num_pairs)
                          [:tm.keep_len])
        deg = np.bincount(pairs[keep, 1], minlength=tm.num_items)
        lonely = np.flatnonzero(deg == 0)
        if len(lonely):
            return key, keep, tm.num_users + int(lonely[0])
    raise AssertionError("no pruning isolates a node")


def _mask_of(tm, keep):
    return layergcn_mask_from_keep(torch.tensor(keep, dtype=torch.int64),
                                   tm._rows, tm._cols, tm._base,
                                   tm.num_users, tm.num_items)


def test_full_graph_forward_matches_jax(pair):
    jm, tm = pair
    params = _set_weights(jm, tm, np.random.default_rng(0))
    ref = jm._forward(jm.params, jm._full_edges())
    got = layergcn_embeddings(tm.graph, torch.from_numpy(params["user_emb"]),
                              torch.from_numpy(params["item_emb"]), 2)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_pruned_forward_and_gradient_match_jax_with_an_isolated_node(pair):
    """The same kept set on both sides (JAX's own pruned edge list, the
    port's mask over the static graph). A node left with no kept edge has
    a zero propagated row, whose cosine weight JAX differentiates to NaN;
    its masked edges add exact zeros, so every gradient stays finite and
    equal to JAX's."""
    jm, tm = pair
    params = _set_weights(jm, tm, np.random.default_rng(1))
    key, keep, lonely = _isolating_key(jm, tm)
    state = jm._pruned_random(key)
    mask = _mask_of(tm, keep)
    assert int((mask[:tm.num_pairs] != 0).sum()) == tm.keep_len
    rng = np.random.default_rng(2)
    cot = [rng.standard_normal((n, DIM)).astype(np.float32)
           for n in (jm.num_users, jm.num_items)]

    def jax_obj(p):
        u, i = jm._forward(p, state)
        return jnp.sum(u * cot[0]) + jnp.sum(i * cot[1])
    ref_val, ref_grad = jax.value_and_grad(jax_obj)(jm.params)
    ue = torch.from_numpy(params["user_emb"]).requires_grad_(True)
    ie = torch.from_numpy(params["item_emb"]).requires_grad_(True)
    u, i = layergcn_embeddings(tm.graph, ue, ie, 2, mask)
    assert torch.count_nonzero(torch.cat([u, i])[lonely]) == 0
    obj = torch.sum(u * torch.from_numpy(cot[0])) \
        + torch.sum(i * torch.from_numpy(cot[1]))
    obj.backward()
    np.testing.assert_allclose(float(obj.detach()), float(ref_val),
                               rtol=1e-5)
    for name, t in (("user_emb", ue), ("item_emb", ie)):
        assert bool(torch.isfinite(t.grad).all())
        assert bool(np.isfinite(np.asarray(ref_grad[name])).all())
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref_grad[name]),
                                   **TOL)


@pytest.mark.parametrize("pruned", [False, True])
def test_train_step_matches_jax(pair, pruned):
    """Same params and Adam state in both, then three fixed batches over
    the full or a pruned graph: each step's loss and the parameters after
    it agree."""
    from jax.flatten_util import ravel_pytree
    jm, tm = pair
    rng = np.random.default_rng(3)
    params = _set_weights(jm, tm, rng, 0.3)
    if pruned:
        key, keep, _ = _isolating_key(jm, tm)
        state, mask = jm._pruned_random(key), _mask_of(tm, keep)
    else:
        state, mask = jm._full_edges(), None
    flat, unravel = ravel_pytree(jm.params)
    mu = rng.standard_normal(flat.shape[0]).astype(np.float32) * 0.05
    nu = rng.uniform(1e-3, 1e-2, flat.shape[0]).astype(np.float32)
    adam, *rest = jm.optimizer.init(jm.params)
    opt = (adam._replace(count=jnp.asarray(4, jnp.int32), mu=unravel(mu),
                         nu=unravel(nu)), *rest)
    tm.load_jax_opt_state(4, mu, nu)
    carry = (jm.params, opt, state)
    step = jax.jit(jm._train_step)
    u, n, b = jm.num_users, jm.num_items, 32
    for _ in range(3):
        batch = (rng.integers(0, u, b), rng.integers(0, n, b),
                 rng.integers(0, n, (b, 1)),
                 (rng.random(b) < 0.9).astype(np.float32))
        carry, ref_loss = step(carry, tuple(
            jnp.asarray(x.astype(np.int32) if x.dtype != np.float32 else x)
            for x in batch))
        loss = tm.train_step(tuple(torch.from_numpy(x) for x in batch)
                             + (mask,))
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
        for key_ in params:
            np.testing.assert_allclose(getattr(tm, key_).detach().numpy(),
                                       np.asarray(carry[0][key_]), **TOL)


def test_pruning_mask_contract(pair):
    """keep_len distinct pairs in each half; even epochs drawn by degree
    (Gumbel top-k over log base), odd ones at random, both from stream 1 of
    (seed + 1, epoch); keeping every pair gives the base graph (mask 1)."""
    _, tm = pair
    e, keep_len = tm.num_pairs, tm.keep_len
    assert keep_len == int(e * (1 - 0.3))
    for epoch in range(4):
        mask = tm.epoch_mask(epoch)
        assert mask.shape == (2 * e,)
        assert torch.equal(mask[:e], mask[e:])
        assert int((mask[:e] != 0).sum()) == keep_len
        gen = epoch_generator(2, epoch, torch.device("cpu"), stream=1)
        keep = layergcn_keep(gen, tm._log_base, keep_len, epoch % 2 == 0)
        assert len(torch.unique(keep)) == keep_len
        assert torch.equal(mask, _mask_of(tm, keep.numpy()))
    assert not torch.equal(tm.epoch_mask(0), tm.epoch_mask(2))
    # by degree favours the edges of large base weight, at random does not
    base = tm._base.numpy()
    kept_base = {even: np.mean([base[tm.epoch_mask(ep)[:e].numpy() != 0]
                                .mean() for ep in range(int(not even), 40, 2)])
                 for even in (True, False)}
    assert kept_base[True] > kept_base[False] * 1.01
    np.testing.assert_allclose(kept_base[False], base.mean(), rtol=0.02)
    full = _mask_of(tm, np.arange(e))
    np.testing.assert_allclose(full.numpy(), 1.0, rtol=1e-6)
    # dropout 0 trains on the full graph
    tm.config.dropout = 0.0
    try:
        assert tm.epoch_mask(0) is None
    finally:
        tm.config.dropout = 0.3


def test_epoch_trains_under_its_mask(pair, monkeypatch):
    """An epoch's steps all see the mask of epoch_mask(epoch); evaluation
    afterwards uses the unpruned graph."""
    _, tm = pair
    seen = []
    real = tm._loss

    def spy(users, pos, neg, w, edge_mask=None):
        seen.append(tm._epoch_mask)
        return real(users, pos, neg, w, edge_mask)
    monkeypatch.setattr(tm, "_loss", spy)
    monkeypatch.setattr(tm, "train_step", make_train_step(tm.optimizer, spy))
    loss = tm._train_epoch(1)
    assert np.isfinite(loss) and len(seen) == tm.pipeline.num_batches
    assert all(torch.equal(m, tm.epoch_mask(1)) for m in seen)
    assert tm._epoch_mask is None


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
    frozen = tm._chunk_embeddings()
    assert all(a is b for a, b in zip(frozen, tm._final_emb))
    ev = tm.evaluator
    for mode in ("fused", "chunked"):
        ev.eval_mode, ev.chunk_size = mode, 32
        try:
            np.testing.assert_allclose(list(tm.evaluate().values()),
                                       list(got.values()), rtol=0, atol=1e-6)
        finally:
            ev.eval_mode = "full"


def test_config_registry_and_fit(pair, tmp_path, monkeypatch):
    jm, tm = pair
    reg = ModelRegistry()
    reg.load_skrx_model("LayerGCN")
    cls, cfg_cls = reg.get_model("LayerGCN")
    assert cls is LayerGCN and cfg_cls is LayerGCNConfig
    defaults, ref = LayerGCNConfig(), JaxLayerGCNConfig()
    for field in ("lr", "reg", "embed_dim", "n_layers", "dropout",
                  "graph_impl", "batch_size", "epochs", "early_stop"):
        assert getattr(defaults, field) == getattr(ref, field), field
    assert LayerGCNConfig.param_space() == JaxLayerGCNConfig.param_space()
    for bad in (dict(dropout=1.0), dict(dropout=-0.1), dict(n_layers=0),
                dict(lr=1), dict(graph_impl="pallas"), dict(reg=-1.0)):
        with pytest.raises(ValueError):
            LayerGCNConfig(**bad)
    monkeypatch.chdir(tmp_path)
    if not torch.cuda.is_available():      # the default device is CUDA
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(RunConfig(data_dir=tm.dataset.data_dir), dict(CFG))
    m = cls(RunConfig(data_dir=tm.dataset.data_dir, seed=1, top_k=(10,)),
            dict(CFG, epochs=2, lr=0.05), device="cpu")
    best = m.fit()
    losses = [h["loss"] for h in m.history]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert 0.0 <= best["NDCG@10"] <= 1.0
