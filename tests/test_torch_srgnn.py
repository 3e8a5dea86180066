"""SRGNN in the port against the JAX package's, on the same data, weights
and Adam state. The vectorised ``prepare_sessions`` equal to JAX's
``_prepare_sessions`` (repeated items and repeated transitions in a
session included), the prefix examples and the two-level shuffle equal to
JAX's, the adjacency of a session whose padded pairs write 0 at alias (0,
0) over a real self-transition there. One train step (JAX's epoch of one
batch) at the first and the second stair of the learning-rate decay: the
loss and every parameter within rtol 1e-5 / atol 1e-6. predict within
rtol 1e-5, evaluate() within 1e-6 of JAX's on the full, fused and chunked
routes; config checks, the registry, the converter and fit()."""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from skrx import RunConfig as JaxRunConfig
from skrx.models.SRGNN import SRGNN as JaxSRGNN
from skrx.models.SRGNN import SRGNNConfig as JaxSRGNNConfig
from skrx.models.SRGNN import _prepare_sessions as jax_prepare_sessions
from skrx.serve import TopKRecommender as JaxTopK
from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.convert import srgnn_params_from_jax
from skrx_torch.models.SRGNN import (SRGNN, SRGNNConfig, prepare_sessions,
                                     session_adjacency, srgnn_session_embed)
from skrx_torch.serve import TopKRecommender

TOL = dict(rtol=1e-5, atol=1e-6)
RUN = dict(seed=1, metric=("NDCG", "Recall"), top_k=(5, 10),
           test_batch_size=16)
SMALL = dict(hidden_size=8, max_seq_len=5, batch_size=16, lr=0.01,
             l2_reg=0.001, step=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_data(root: str) -> str:
    """16 users x 30 items in time order, 1..9 training items a user drawn
    with repeats from 12 (repeated transitions and self-transitions), one
    test item outside them."""
    rng = np.random.default_rng(8)
    train, test = [], []
    for u in range(16):
        n = 1 if u == 2 else int(rng.integers(2, 10))
        pool = rng.permutation(30)
        items = rng.choice(pool[:12], n)
        train += [(u, int(i), 1, t) for t, i in enumerate(items)]
        test.append((u, int(pool[12 + u % 18]), 1, 99))
    name = "sessions"
    out = os.path.join(root, name)
    os.makedirs(out, exist_ok=True)
    for suffix, rows in ((".train", train), (".test", test)):
        np.savetxt(os.path.join(out, name + suffix), np.array(rows),
                   fmt="%d", delimiter="\t")
    return out


@pytest.fixture(scope="module")
def build(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_srgnn")
    data = _write_data(str(root))
    cache = {}

    def make(**over):
        key = tuple(sorted(over.items()))
        if key not in cache:
            cfg = dict(SMALL, **over)
            cwd = os.getcwd()
            os.chdir(root)
            try:
                jm = JaxSRGNN(JaxRunConfig(recommender="SRGNN", data_dir=data,
                                           **RUN), dict(cfg))
                tm = SRGNN(RunConfig(data_dir=data, **RUN), dict(cfg),
                           device="cpu")
            finally:
                os.chdir(cwd)
            cache[key] = (jm, tm)
        return cache[key]
    return make


def _set_weights(jm, tm, rng):
    params = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, jm.params))
    jm.params = jax.tree_util.tree_map(jnp.asarray, params)
    tm.load_jax_params(params)
    return params


def test_prepare_sessions_matches_jax():
    rng = np.random.default_rng(2)
    seqs = [rng.integers(0, 9, int(n)).astype(np.int32)
            for n in rng.integers(1, 12, 60)]
    seqs += [np.array([4, 4, 4], np.int32), np.array([7], np.int32),
             np.array([3, 1, 3, 1, 3], np.int32)]
    lens = np.array([len(s) for s in seqs])
    ends = np.cumsum(lens)
    starts = ends - lens
    items = np.concatenate(seqs)
    l_max = int(lens.max())
    n_max = max(len(np.unique(s)) for s in seqs)
    ref = jax_prepare_sessions(seqs, l_max, n_max, 9)
    got = prepare_sessions(items, starts, ends, l_max, None, 9)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    wide = prepare_sessions(items, starts, ends, l_max, n_max + 3, 9)
    np.testing.assert_array_equal(wide[0][:, :n_max], ref[0])
    assert (wide[0][:, n_max:] == 9).all()


def test_prefix_examples_and_shuffle_match_jax(build):
    jm, tm = build()
    assert tm.num_examples == jm._n_examples
    assert (tm.l_max, tm.n_max) == (jm._l_max, jm._n_max)
    for got, ref in ((tm.nodes, jm._nodes), (tm.alias, jm._alias),
                     (tm.lengths, jm._lengths), (tm.targets, jm._targets),
                     (tm.t_nodes, jm._t_nodes), (tm.t_alias, jm._t_alias),
                     (tm.t_lengths, jm._t_lengths)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for epoch in (0, 3):
        np.testing.assert_array_equal(tm.shuffled_order(epoch),
                                      jm._shuffled_order(epoch))


def test_adjacency_keeps_a_real_pair_under_padded_writes():
    """Session [5, 5, 7] (alias 0, 0, 1) in a row of 5: the real (0, 0) and
    (0, 1) transitions; the padded pairs at t >= 2 write 0 at (0, 0)."""
    alias = torch.tensor([[0, 0, 1, 0, 0], [0, 1, 0, 2, 0]])
    lengths = torch.tensor([3, 5])
    a_in, a_out = session_adjacency(alias, lengths, 3)
    adj0 = torch.tensor([[1., 1, 0], [0, 0, 0], [0, 0, 0]])
    np.testing.assert_array_equal(a_in[0].numpy(), adj0.numpy())
    np.testing.assert_array_equal(a_out[0].numpy(),
                                  (adj0.T / 2).numpy())  # row 0: out 2
    adj1 = torch.tensor([[0., 1, 1], [1, 0, 0], [1, 0, 0]])  # repeated 0->1
    np.testing.assert_array_equal(a_in[1].numpy(),
                                  (adj1 / adj1.sum(0).clamp(min=1)).numpy())


@pytest.mark.parametrize("stair", [0, 1])
def test_train_step_matches_jax(build, stair):
    jm, tm = build()
    rng = np.random.default_rng(11 + stair)
    params = _set_weights(jm, tm, rng)
    from jax.flatten_util import ravel_pytree
    flat, unravel = ravel_pytree(jm.params)
    mu = rng.standard_normal(flat.shape[0]).astype(np.float32) * 0.05
    nu = rng.uniform(1e-3, 1e-2, flat.shape[0]).astype(np.float32)
    decay_steps = max(int(3 * tm.num_examples / 16), 1)
    count = stair * decay_steps
    adam, sched = jm.opt_state
    opt_state = (adam._replace(count=jnp.asarray(count, jnp.int32),
                               mu=unravel(mu), nu=unravel(nu)),
                 sched._replace(count=jnp.asarray(count, jnp.int32)))
    tm.load_jax_opt_state(count, mu, nu)
    tm.update_count = count
    assert tm.lr_schedule(count) == pytest.approx(0.01 * 0.1 ** stair)
    order = tm.shuffled_order(1)[:16]
    p, jm.opt_state, ref_loss = jm._run_epoch(jm.params, opt_state,
                                              jnp.asarray(order))
    jm.params = p                          # the epoch donates its inputs
    idx = torch.from_numpy(order.astype(np.int64))
    loss = float(tm.train_step((tm.nodes[idx], tm.alias[idx],
                                tm.lengths[idx], tm.targets[idx])))
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-5)
    assert tm.update_count == count + 1
    ref = srgnn_params_from_jax(jax.tree_util.tree_map(np.asarray, p))
    start = srgnn_params_from_jax(params)
    got = dict(tm.named_parameters())
    assert set(got) == set(ref)
    for key, value in ref.items():
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   value.numpy(), **TOL, err_msg=key)
        assert not np.array_equal(value.numpy(), start[key].numpy()), key


@pytest.mark.parametrize("nonhybrid", [False, True])
def test_predict_routes_and_recommend_match_jax(build, nonhybrid):
    jm, tm = build(nonhybrid=nonhybrid)
    _set_weights(jm, tm, np.random.default_rng(5))
    users = np.arange(tm.num_users)
    uv = tm._cached_user_vectors(users)
    np.testing.assert_allclose(uv.numpy(),
                               np.asarray(jm._user_vectors(users)), **TOL)
    emb = srgnn_session_embed(tm.params_tree(), tm.config, tm.t_nodes.long(),
                              tm.t_alias.long(), tm.t_lengths.long())
    np.testing.assert_allclose(emb.detach().numpy(), uv.numpy(), **TOL)
    np.testing.assert_allclose(tm.predict(users).numpy(),
                               np.asarray(jm.predict(users)), **TOL)
    ref, got = jm.evaluate(), tm.evaluate()
    np.testing.assert_allclose(list(got.values()), list(ref.values()),
                               rtol=0, atol=1e-6)
    ev = tm.evaluator
    for mode in ("fused", "chunked"):
        ev.eval_mode, ev.chunk_size = mode, 5
        try:
            np.testing.assert_allclose(list(tm.evaluate().values()),
                                       list(got.values()), rtol=0, atol=1e-6)
        finally:
            ev.eval_mode = "full"
    ids, vals = TopKRecommender(tm, k=4).recommend(users)
    ref_ids, ref_vals = JaxTopK(jm, k=4).recommend(users)
    np.testing.assert_array_equal(ids, np.asarray(ref_ids))
    np.testing.assert_allclose(vals, np.asarray(ref_vals), **TOL)


def test_config_registry_converter_and_fit(build, tmp_path, monkeypatch):
    jm, tm = build()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SRGNN(RunConfig(data_dir=tm.dataset.data_dir), dict(SMALL))
    reg = ModelRegistry()
    reg.load_skrx_model("SRGNN")
    assert reg.get_model("SRGNN") == (SRGNN, SRGNNConfig)
    defaults, ref = SRGNNConfig(), JaxSRGNNConfig()
    for field in defaults.to_dict():
        assert getattr(defaults, field) == getattr(ref, field), field
    for bad in (dict(lr=1), dict(step=0), dict(nonhybrid=1),
                dict(max_seq_len=0)):
        with pytest.raises(ValueError):
            SRGNNConfig(**bad)
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    with pytest.raises(ValueError):
        srgnn_params_from_jax({k: v for k, v in params.items() if k != "B"})
    with pytest.raises(ValueError):
        srgnn_params_from_jax(dict(params, B=params["B"][:3]))
    monkeypatch.chdir(tmp_path)
    run = dict(data_dir=tm.dataset.data_dir, seed=1, top_k=(10,),
               checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1)
    m = SRGNN(RunConfig(**run), dict(SMALL, epochs=2), device="cpu")
    m.fit()
    losses = [h["loss"] for h in m.history]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert m.update_count == 2 * m.num_batches
    resumed = SRGNN(RunConfig(**run, resume=True), dict(SMALL, epochs=3),
                    device="cpu")
    resumed.fit()
    assert [h["epoch"] for h in resumed.history] == [2]
    assert resumed.update_count == 3 * m.num_batches
