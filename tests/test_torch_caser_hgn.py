"""Caser and HGN in the port against the JAX package's, on the same data,
weights, Adam state (``adam_l2``: weight decay on every leaf, the pad rows
too) and batch. One train step (Caser with JAX's dropout mask, rebuilt
from the step's key, at dropout 0.5 and 0): the loss and every parameter
within rtol 1e-5 / atol 1e-6. predict over the N + 1 columns within rtol
1e-5, evaluate() within 1e-6 of JAX's on every route (full, fused,
chunked), and recommend() equal to JAX's, on a dataset with one user whose
seen row is full (column N, the pad, can be recommended with score 0) and
users whose rows are padded (column N masked); the Adam state from JAX's
order (``conv_h/<i>``); two ``optimizer="lazy_adam"`` steps (lazy Adam on
the tables' gathered rows from JAX's random per-table state, dense Adam
with weight decay on the rest from JAX's random moments; Caser with JAX's
dropout masks) within the same tolerance; config, registry, converters,
and fit() with checkpoint and resume (also with lazy Adam)."""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from skrx import RunConfig as JaxRunConfig
from skrx.models.Caser import Caser as JaxCaser
from skrx.models.Caser import CaserConfig as JaxCaserConfig
from skrx.models.HGN import HGN as JaxHGN
from skrx.models.HGN import HGNConfig as JaxHGNConfig
from skrx.serve import TopKRecommender as JaxTopK
from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.convert import caser_params_from_jax, hgn_params_from_jax
from skrx_torch.models.Caser import Caser, CaserConfig
from skrx_torch.models.HGN import HGN, HGNConfig
from skrx_torch.models.pipeline import epoch_generator
from skrx_torch.serve import TopKRecommender

DIM, L, T = 8, 4, 2
TOL = dict(rtol=1e-5, atol=1e-6)
RUN = dict(seed=1, metric=("NDCG", "Recall"), top_k=(5, 10),
           test_batch_size=8)
NUM_USERS, NUM_ITEMS, FULL_USER = 12, 40, 0
MODELS = {"Caser": (JaxCaser, Caser, JaxCaserConfig, CaserConfig,
                    caser_params_from_jax,
                    dict(embed_size=DIM, seq_L=L, seq_T=T, nv=2, nh=3,
                         lr=0.01, l2_reg=0.01, batch_size=16)),
          "HGN": (JaxHGN, HGN, JaxHGNConfig, HGNConfig, hgn_params_from_jax,
                  dict(embed_size=DIM, seq_L=L, seq_T=T, lr=0.01, reg=0.01,
                       batch_size=16))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_data(root: str) -> str:
    """12 users x 40 items: user 0 holds 32 training items (a full row of
    the padded seen table), the others 3..9; two test items each."""
    rng = np.random.default_rng(4)
    train, test = [], []
    for u in range(NUM_USERS):
        n = 32 if u == FULL_USER else int(rng.integers(3, 10))
        items = rng.permutation(NUM_ITEMS)
        train += [(u, int(i), 1, t) for t, i in enumerate(items[:n])]
        test += [(u, int(i), 1, 99) for i in items[n:n + 2]]
    name = "padcol"
    out = os.path.join(root, name)
    os.makedirs(out, exist_ok=True)
    for suffix, rows in ((".train", train), (".test", test)):
        np.savetxt(os.path.join(out, name + suffix), np.array(rows),
                   fmt="%d", delimiter="\t")
    return out


@pytest.fixture(scope="module")
def build(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_caser_hgn")
    data = _write_data(str(root))
    cache = {}

    def make(name, **over):
        key = (name,) + tuple(sorted(over.items()))
        if key not in cache:
            jcls, tcls, *_, cfg = MODELS[name]
            cfg = dict(cfg, **over)
            cwd = os.getcwd()
            os.chdir(root)                 # the models write log/ here
            try:
                jm = jcls(JaxRunConfig(recommender=name, data_dir=data,
                                       **RUN), dict(cfg))
                tm = tcls(RunConfig(data_dir=data, **RUN), dict(cfg),
                          device="cpu")
            finally:
                os.chdir(cwd)
            cache[key] = (jm, tm)
        return cache[key]
    return make


def _set_weights(name, jm, tm, rng, bias_shift=0.0):
    """JAX's param tree with random values (``b2`` shifted by
    ``bias_shift``), loaded in both."""
    params = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, jm.params))
    params["b2"] = params["b2"] + np.float32(bias_shift)
    jm.params = jax.tree_util.tree_map(jnp.asarray, params)
    tm.load_jax_params(params)
    return params


def _adam_state(jm, rng):
    """JAX's opt_state with a random ScaleByAdamState (count 3), and its
    (count, mu, nu) raveled in JAX's order."""
    from jax.flatten_util import ravel_pytree
    flat, unravel = ravel_pytree(jm.params)
    mu = rng.standard_normal(flat.shape[0]).astype(np.float32) * 0.05
    nu = rng.uniform(1e-3, 1e-2, flat.shape[0]).astype(np.float32)
    state = tuple(
        s._replace(count=jnp.asarray(3, jnp.int32), mu=unravel(mu),
                   nu=unravel(nu)) if hasattr(s, "mu") else s
        for s in jm.opt_state)
    return state, (3, mu, nu)


@pytest.mark.parametrize("name,dropout", [("Caser", 0.5), ("Caser", 0.0),
                                          ("HGN", None)])
def test_train_step_matches_jax(build, name, dropout):
    over = {} if dropout is None else dict(dropout=dropout)
    jm, tm = build(name, **over)
    convert = MODELS[name][4]
    rng = np.random.default_rng(11)
    params = _set_weights(name, jm, tm, rng)
    opt_state, flat_state = _adam_state(jm, rng)
    tm.load_jax_opt_state(*flat_state)
    batch = next(tm.pipeline.batches(epoch_generator(3, 0,
                                                     torch.device("cpu"))))
    assert batch[1].shape == (16, T) and batch[4].shape == (16, L)
    assert (batch[4] == NUM_ITEMS).any()                 # pre-padded
    jbatch = tuple(jnp.asarray(x.numpy().astype(
        np.float32 if x.dtype == torch.float32 else np.int32)) for x in batch)
    if name == "Caser":
        key = jax.random.key(9)
        (p, _, _), ref_loss = jax.jit(jm._step_with_key)(
            (jm.params, opt_state, key), jbatch)
        keep = None
        if dropout:
            width = tm.config.nv * DIM + tm.config.nh * L
            keep = torch.from_numpy(np.array(jax.random.bernoulli(
                jax.random.split(key)[1], 1 - dropout, (16, width))))
        loss = tm.train_step((*batch, keep))
    else:
        (p, _), ref_loss = jax.jit(jm._train_step)((jm.params, opt_state),
                                                   jbatch)
        loss = tm.train_step(batch)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    ref = convert(jax.tree_util.tree_map(np.asarray, p))
    start = convert(params)
    got = dict(tm.named_parameters())
    assert set(got) == set(ref)
    for key_, value in ref.items():
        np.testing.assert_allclose(got[key_].detach().numpy(),
                                   value.numpy(), **TOL, err_msg=key_)
        assert not np.array_equal(value.numpy(), start[key_].numpy()), key_
    # the pad rows get no gradient, only weight decay
    for table in ("item_emb", "W2", "b2"):
        np.testing.assert_allclose(
            got[table].detach().numpy()[NUM_ITEMS],
            ref[table].numpy()[NUM_ITEMS], **TOL)


def test_adam_state_from_jax_order(build):
    """JAX ravels Caser's params by sorted key, its lists by index
    (``conv_h/0`` .. ``conv_h/3`` before ``conv_h_b/0``); each moment lands
    on its parameter."""
    from jax.flatten_util import ravel_pytree
    jm, tm = build("Caser")
    tree = jax.tree_util.tree_map(
        lambda a: np.arange(a.size, dtype=np.float32).reshape(a.shape)
        + np.float32(a.ndim), jax.tree_util.tree_map(np.asarray, jm.params))
    flat = np.asarray(ravel_pytree(jax.tree_util.tree_map(jnp.asarray,
                                                          tree))[0])
    tm.load_jax_opt_state(5, flat, 2 * flat)
    want = caser_params_from_jax(tree)
    for name, param in tm.named_parameters():
        state = tm.optimizer.state[param]
        assert float(state["step"]) == 5.0
        np.testing.assert_array_equal(state["exp_avg"].numpy(),
                                      want[name].numpy(), err_msg=name)
        np.testing.assert_array_equal(state["exp_avg_sq"].numpy(),
                                      2 * want[name].numpy())


def _lazy_state(rng, shape):
    from skrx.ops import optim as joptim
    return joptim.LazyAdamState(
        jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 0.05),
        jnp.asarray(rng.uniform(1e-3, 1e-2, shape).astype(np.float32)),
        jnp.asarray(rng.integers(0, 5, shape[0]).astype(np.int32)))


def _dense_state(dense_state, dense_params, rng, count):
    """JAX's dense Adam state (``adam_l2``'s chain) with random moments at
    ``count``, and (count, mu, nu) raveled in JAX's order."""
    from jax.flatten_util import ravel_pytree
    flat, unravel = ravel_pytree(dense_params)
    mu = rng.standard_normal(flat.shape[0]).astype(np.float32) * 0.05
    nu = rng.uniform(1e-3, 1e-2, flat.shape[0]).astype(np.float32)

    def fill(st):
        if not hasattr(st, "_fields"):
            return tuple(fill(x) for x in st)
        if "mu" in st._fields:
            return st._replace(count=jnp.asarray(count, jnp.int32),
                               mu=unravel(mu), nu=unravel(nu))
        return st
    return fill(dense_state), (count, mu, nu)


@pytest.mark.parametrize("name,dropout", [("Caser", 0.5), ("Caser", 0.0),
                                          ("HGN", None)])
def test_lazy_adam_steps_match_jax(build, name, dropout):
    over = dict(optimizer="lazy_adam")
    if dropout is not None:
        over.update(dropout=dropout)
    jm, tm = build(name, **over)
    convert = MODELS[name][4]
    rng = np.random.default_rng(12)
    params = _set_weights(name, jm, tm, rng)
    lazy, dense = jm.opt_state
    lazy = {k: _lazy_state(rng, params[k].shape) for k in lazy}
    dense_params = {k: v for k, v in jm.params.items() if k not in lazy}
    dense, flat_dense = _dense_state(dense, dense_params, rng, 2)
    tm.load_jax_opt_state(lazy, flat_dense)
    assert sorted(tm.optimizer.tables) == ["W2", "b2", "item_emb",
                                           "user_emb"]
    carry = (jm.params, (lazy, dense))
    gen = epoch_generator(3, 0, torch.device("cpu"))
    width = tm.config.nv * DIM + tm.config.nh * L if name == "Caser" else 0
    key = jax.random.key(9)
    for batch in list(tm.pipeline.batches(gen))[:2]:
        jbatch = tuple(jnp.asarray(x.numpy().astype(
            np.float32 if x.dtype == torch.float32 else np.int32))
            for x in batch)
        if name == "Caser":
            (p, state, key2), ref_loss = jax.jit(jm._step_with_key)(
                (*carry, key), jbatch)
            keep = None
            if dropout:
                keep = torch.from_numpy(np.array(jax.random.bernoulli(
                    jax.random.split(key)[1], 1 - dropout, (16, width))))
            key = key2
            loss = tm.train_step((*batch, keep))
        else:
            (p, state), ref_loss = jax.jit(jm._train_step)(carry, jbatch)
            loss = tm.train_step(batch)
        carry = (p, state)
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    ref = convert(jax.tree_util.tree_map(np.asarray, carry[0]))
    start = convert(params)
    got = dict(tm.named_parameters())
    for key_, value in ref.items():
        np.testing.assert_allclose(got[key_].detach().numpy(),
                                   value.numpy(), **TOL, err_msg=key_)
        assert not np.array_equal(value.numpy(), start[key_].numpy()), key_
    for table, st in carry[1][0].items():        # the lazy state too
        live = tm.optimizer.states[table]
        np.testing.assert_array_equal(live.counts.numpy(),
                                      np.asarray(st.counts))
        np.testing.assert_allclose(live.m.numpy(), np.asarray(st.m), **TOL)


@pytest.mark.parametrize("name", ["Caser", "HGN"])
def test_predict_routes_and_recommend_match_jax(build, name):
    """b2 shifted to -2: the pad column (score 0) outranks most items, so
    it takes a slot of every user's top-k in evaluation (the evaluator's
    pad id is N + 1) and of the full user's recommendations, and is masked
    in the others'."""
    jm, tm = build(name)
    _set_weights(name, jm, tm, np.random.default_rng(5), bias_shift=-2.0)
    users = np.arange(NUM_USERS)
    scores = tm.predict(users).numpy()
    assert scores.shape == (NUM_USERS, NUM_ITEMS + 1)
    assert not scores[:, NUM_ITEMS].any()
    np.testing.assert_allclose(scores, np.asarray(jm.predict(users)), **TOL)
    uv = tm._cached_user_vectors(users)
    np.testing.assert_allclose(uv.numpy(),
                               np.asarray(jm._user_vectors(users)), **TOL)
    ref_f = jm._topk_factors(jm._user_vectors(users))
    for got, want in zip(tm._topk_factors(uv), ref_f):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)
    ref, got = jm.evaluate(), tm.evaluate()
    assert list(got.metrics()) == list(ref.metrics())
    np.testing.assert_allclose(list(got.values()), list(ref.values()),
                               rtol=0, atol=1e-6)
    ev = tm.evaluator
    for mode in ("fused", "chunked"):
        ev.eval_mode, ev.chunk_size = mode, 16        # a chunk holds col N
        try:
            np.testing.assert_allclose(list(tm.evaluate().values()),
                                       list(got.values()), rtol=0, atol=1e-6)
        finally:
            ev.eval_mode = "full"
    ids, vals = TopKRecommender(tm, k=6).recommend(users)
    ref_ids, ref_vals = JaxTopK(jm, k=6).recommend(users)
    np.testing.assert_array_equal(ids, np.asarray(ref_ids))
    np.testing.assert_allclose(vals, np.asarray(ref_vals), **TOL)
    assert NUM_ITEMS in ids[FULL_USER]                # its row is full
    assert NUM_ITEMS not in ids[np.arange(NUM_USERS) != FULL_USER]


@pytest.mark.parametrize("name", ["Caser", "HGN"])
def test_config_registry_converters_and_fit(build, name, tmp_path,
                                            monkeypatch):
    jm, tm = build(name)
    _, cls, jcfg_cls, cfg_cls, convert, small = MODELS[name]
    reg = ModelRegistry()
    reg.load_skrx_model(name)
    assert reg.get_model(name) == (cls, cfg_cls)
    defaults, ref = cfg_cls(), jcfg_cls()
    for field in defaults.to_dict():
        assert getattr(defaults, field) == getattr(ref, field), field
    for bad in (dict(optimizer="sgd"), dict(seq_L=0), dict(seq_T=0),
                dict(lr=1)):
        with pytest.raises(ValueError):
            cfg_cls(**bad)
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    with pytest.raises(ValueError):
        convert({k: v for k, v in params.items() if k != "b2"})
    with pytest.raises(ValueError):
        convert(dict(params, W2=params["W2"][:, :3]))
    monkeypatch.chdir(tmp_path)
    run = dict(data_dir=tm.dataset.data_dir, seed=1, top_k=(10,),
               checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1)
    lazy = cls(RunConfig(**dict(run, checkpoint_dir=str(tmp_path / "lz"))),
               dict(small, optimizer="lazy_adam", epochs=1), device="cpu")
    lazy.fit()
    assert np.isfinite(lazy.history[0]["loss"])
    assert "dense_optimizer" in lazy._train_state()
    m = cls(RunConfig(**run), dict(small, epochs=2), device="cpu")
    if name == "Caser":                 # each step's mask from stream 1
        drawn = []
        real = m.step_keep_mask
        m.step_keep_mask = lambda b: drawn.append(real(b)) or drawn[-1]
    m.fit()
    losses = [h["loss"] for h in m.history]
    assert len(losses) == 2 and all(np.isfinite(losses))
    if name == "Caser":
        steps = m.pipeline.num_batches
        assert len(drawn) == 2 * steps
        gen = epoch_generator(2, 1, torch.device("cpu"), stream=1)
        width = m.config.nv * DIM + m.config.nh * L
        assert torch.equal(drawn[steps], torch.rand((16, width),
                                                    generator=gen) < 0.5)
    resumed = cls(RunConfig(**run, resume=True), dict(small, epochs=3),
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
    for pname, value in m.named_parameters():
        assert torch.equal(state[pname], value.detach()), pname
