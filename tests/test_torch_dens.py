"""DENS in the port against the JAX package's, on the same data, weights,
Adam state, batch and anneal, with dropout off: one train step (loss and
every parameter within rtol 1e-5 / atol 1e-6) for each negative strategy,
two poolings and K of 1 and 2; the first of tied candidates; the Adam state
carried over from JAX's raveled order; predict and evaluate() (metrics
within 1e-6). JAX runs ``graph_impl="segment"``."""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from skrx import RunConfig as JaxRunConfig
from skrx.io import synthetic as jax_synthetic
from skrx.models.DENS import DENS as JaxDENS
from skrx.models.DENS import DENSConfig as JaxDENSConfig
from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.convert import DENS_GATES, dens_params_from_jax
from skrx_torch.models.DENS import (DENS, DENSConfig, dens_dropout_masks,
                                    dens_select)
from skrx_torch.models.pipeline import epoch_generator

DIM = 8
CFG = dict(dim=DIM, context_hops=2, n_negs=3, lr=0.01, l2=0.01, gamma=0.3,
           batch_size=32)
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
    root = tmp_path_factory.mktemp("torch_dens")
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
                jm = JaxDENS(JaxRunConfig(recommender="DENS", data_dir=data,
                                          **RUN),
                             dict(cfg, graph_impl="segment"))
                tm = DENS(RunConfig(data_dir=data, **RUN), cfg, device="cpu")
            finally:
                os.chdir(cwd)
            cache[key] = (jm, tm)
        return cache[key]
    return make


def _jax_params(rng, u, n, scale=0.3):
    def mat(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    params = {"user_emb": mat(u, DIM), "item_emb": mat(n, DIM)}
    for gate in DENS_GATES:
        params[gate] = {"w": mat(DIM, DIM), "b": mat(DIM)}
    return params


def _set_weights(jm, tm, rng, scale=0.3):
    params = _jax_params(rng, jm.num_users, jm.num_items, scale)
    jm.params = jax.tree_util.tree_map(jnp.asarray, params)
    jm._final = None
    tm.load_jax_params(params)
    return params


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("pool", ["mean", "concat"])
@pytest.mark.parametrize("ns", ["rns", "dns", "dens"])
def test_train_step_matches_jax(build, ns, pool, K):
    """Same params and Adam state (count 3, JAX's moments converted), the
    same batch of K groups of n_negs candidates, anneal 0.6: the loss and
    every parameter after one step agree."""
    from jax.flatten_util import ravel_pytree
    jm, tm = build(ns=ns, pool=pool, K=K)
    rng = np.random.default_rng(11)
    params = _set_weights(jm, tm, rng)
    flat, unravel = ravel_pytree(jm.params)
    mu = rng.standard_normal(flat.shape[0]).astype(np.float32) * 0.05
    nu = rng.uniform(1e-3, 1e-2, flat.shape[0]).astype(np.float32)
    adam, *rest = jm.optimizer.init(jm.params)
    opt = (adam._replace(count=jnp.asarray(3, jnp.int32), mu=unravel(mu),
                         nu=unravel(nu)), *rest)
    tm.load_jax_opt_state(3, mu, nu)
    b = 32
    batch = (rng.integers(0, jm.num_users, b), rng.integers(0, jm.num_items, b),
             rng.integers(0, jm.num_items, (b, K * 3)),
             (rng.random(b) < 0.9).astype(np.float32))
    anneal = 0.6
    carry = (jm.params, opt, jax.random.key(0), jnp.asarray(anneal,
                                                           jnp.float32))
    carry, ref_loss = jm._step_with_key(carry, tuple(
        jnp.asarray(x.astype(np.int32) if x.dtype != np.float32 else x)
        for x in batch))
    tm.anneal = anneal
    loss = tm.train_step(tuple(torch.from_numpy(x) for x in batch))
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    ref = dens_params_from_jax(jax.tree_util.tree_map(np.asarray, carry[0]))
    got = dict(tm.named_parameters())
    assert set(got) == set(ref)
    for name, value in ref.items():
        np.testing.assert_allclose(got[name].detach().numpy(), value.numpy(),
                                   **TOL, err_msg=name)
    assert any(not np.allclose(got[k].detach().numpy(),
                               dens_params_from_jax(params)[k].numpy())
               for k in got)


def test_tied_candidates_resolve_to_the_first(build):
    """Per hop, candidates whose scores tie exactly: the first wins, as
    jnp.argmax picks it; a hop where every score is 0 takes candidate 0."""
    _, tm = build(ns="dens", pool="mean", K=1)
    params = {k: v.detach().clone() for k, v in tm.named_parameters()}
    for gate in ("neg_gate", "pos_gate"):       # gate_n = sigmoid(-30) ~ 0
        params[f"{gate}.weight"].zero_()
        params[f"{gate}.bias"].fill_(-15.0)
    b, c, h, d = 4, 5, 3, DIM
    rng = np.random.default_rng(0)
    s_e = torch.zeros((b, h, d))
    s_e[:, 0, 0] = 1.0                           # hop 0 scores dim 0
    s_e[:, 1, 1] = 1.0                           # hop 1 scores dim 1
    n_e = torch.from_numpy(rng.uniform(-1, 1, (b, c, h, d))
                           .astype(np.float32))
    n_e[:, 1, 0, 0] = n_e[:, 3, 0, 0] = 4.0      # tie of 1 and 3 at hop 0
    n_e[:, 2, 1, 1] = n_e[:, 4, 1, 1] = 4.0      # tie of 2 and 4 at hop 1
    p_e = torch.from_numpy(rng.uniform(-1, 1, (b, h, d)).astype(np.float32))
    sel = dens_select(params, "dens", "mean", s_e, p_e, n_e, 0.5)
    for hop, first in ((0, 1), (1, 2), (2, 0)):
        assert torch.equal(sel[:, hop], n_e[:, first, hop])
    scores = np.einsum("bhd,bchd->bch", s_e.numpy(), n_e.numpy()) * 0.5
    assert np.asarray(jnp.argmax(jnp.asarray(scores), axis=1)).tolist() \
        == [[1, 2, 0]] * b


def test_adam_state_from_jax_order_and_layout(build):
    """JAX ravels the nested params by sorted path (item_emb, item_gate/b,
    item_gate/w, ..., user_gate/w); each moment lands on its parameter, a
    gate's w transposed as its weight."""
    from jax.flatten_util import ravel_pytree
    jm, tm = build(ns="dens", pool="mean", K=1)
    tree = _jax_params(np.random.default_rng(2), jm.num_users, jm.num_items)
    flat, _ = ravel_pytree(jax.tree_util.tree_map(jnp.asarray, tree))
    flat = np.asarray(flat)
    np.testing.assert_array_equal(flat[:tm.num_items * DIM],
                                  tree["item_emb"].ravel())
    np.testing.assert_array_equal(flat[tm.num_items * DIM:][:DIM],
                                  tree["item_gate"]["b"])
    tm.load_jax_opt_state(5, flat, 2 * flat)
    want = dens_params_from_jax(tree)
    for name, param in tm.named_parameters():
        state = tm.optimizer.state[param]
        assert float(state["step"]) == 5.0
        np.testing.assert_array_equal(state["exp_avg"].numpy(),
                                      want[name].numpy())
        np.testing.assert_array_equal(state["exp_avg_sq"].numpy(),
                                      2 * want[name].numpy())
    with pytest.raises(ValueError):
        tm.load_jax_opt_state(5, flat[:-1], flat[:-1])
    with pytest.raises(ValueError):
        dens_params_from_jax(dict(tree, user_gate={"w": np.zeros((3, 3)),
                                                   "b": np.zeros(3)}))


@pytest.mark.parametrize("pool", ["mean", "concat"])
def test_predict_and_evaluate_match_jax(build, pool):
    jm, tm = build(ns="dens", pool=pool, K=1)
    _set_weights(jm, tm, np.random.default_rng(8), 1.0)
    users = np.arange(jm.num_users)
    np.testing.assert_allclose(tm.predict(users).numpy(),
                               np.asarray(jm.predict(users)), rtol=1e-5,
                               atol=1e-5)
    ref, got = jm.evaluate(), tm.evaluate()
    assert list(got.metrics()) == list(ref.metrics())
    np.testing.assert_allclose(list(got.values()), list(ref.values()),
                               rtol=1e-6, atol=1e-7)
    ev = tm.evaluator
    for mode in ("fused", "chunked"):
        ev.eval_mode, ev.chunk_size = mode, 32
        try:
            np.testing.assert_allclose(list(tm.evaluate().values()),
                                       list(got.values()), rtol=0, atol=1e-6)
        finally:
            ev.eval_mode = "full"


def test_config_registry_dropout_and_fit(build, tmp_path, monkeypatch):
    """Config and registry; fit() with edge and message dropout: the masks
    of a step come from stream 1 of (seed + 1, epoch), per hop an (E,)
    edge mask then an (n, d) message mask; anneal follows the epoch;
    checkpoint and resume carry the gates."""
    _, tm = build(ns="dens", pool="mean", K=1)
    reg = ModelRegistry()
    reg.load_skrx_model("DENS")
    cls, cfg_cls = reg.get_model("DENS")
    assert cls is DENS and cfg_cls is DENSConfig
    defaults, ref = DENSConfig(), JaxDENSConfig()
    for field in defaults.to_dict():
        assert getattr(defaults, field) == getattr(ref, field), field
    for bad in (dict(ns="hard"), dict(pool="max"), dict(K=0), dict(n_negs=0),
                dict(context_hops=-1), dict(warmup=-1), dict(lr=1)):
        with pytest.raises(ValueError):
            DENSConfig(**bad)
    monkeypatch.chdir(tmp_path)
    if not torch.cuda.is_available():      # the default device is CUDA
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(RunConfig(data_dir=tm.dataset.data_dir), dict(CFG))
    run = RunConfig(data_dir=tm.dataset.data_dir, seed=1, top_k=(10,),
                    checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1)
    cfg = dict(CFG, epochs=2, warmup=4, edge_dropout=True, mess_dropout=True)
    m = cls(run, cfg, device="cpu")
    drawn, anneals = [], []
    real = m.step_masks

    def spy():
        drawn.append(real())
        anneals.append(m.anneal)
        return drawn[-1]
    monkeypatch.setattr(m, "step_masks", spy)
    m.fit()
    losses = [h["loss"] for h in m.history]
    assert len(losses) == 2 and all(np.isfinite(losses))
    steps = m.pipeline.num_batches
    assert len(drawn) == 2 * steps and anneals == [1.0] * steps + [0.75] * steps
    gen = epoch_generator(2, 1, torch.device("cpu"), stream=1)
    want = dens_dropout_masks(gen, m.graph, 2, DIM, 0.1, 0.1)
    for (edge, keep), (w_edge, w_keep) in zip(drawn[steps], want):
        assert edge.shape == (m.graph.num_edges,)
        assert keep.shape == (m.graph.num_nodes, DIM)
        assert torch.equal(edge, w_edge) and torch.equal(keep, w_keep)
    resumed = cls(RunConfig(data_dir=tm.dataset.data_dir, seed=1,
                            top_k=(10,), checkpoint_dir=str(tmp_path / "ck"),
                            checkpoint_every=1, resume=True),
                  dict(cfg, epochs=3), device="cpu")
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
