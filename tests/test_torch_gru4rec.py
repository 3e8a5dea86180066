"""GRU4Rec and GRU4RecPlus in the port against the JAX package's, on the
same data, weights and Adam state. The walker's schedule equal to
``build_walker_schedule`` and to the on-device walker's emitted slots, its
step count to ``walker_num_steps``, on random sessions, sessions of length
1 and more rows than sessions. A whole epoch (every step of the walk) of
each loss, GRU4RecPlus with JAX's negatives (its key split at every slot,
the skipped ones too): the epoch's loss and every parameter within rtol
1e-5 / atol 1e-6. predict within rtol 1e-5, evaluate() within 1e-6 of
JAX's on the full, fused and chunked routes, a relu ``final_act`` kept off
the fused route, the user states computed anew after a step; config
checks, the registry and the converter."""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from skrx import RunConfig as JaxRunConfig
from skrx.models.GRU4Rec import GRU4Rec as JaxGRU4Rec
from skrx.models.GRU4Rec import GRU4RecConfig as JaxGRU4RecConfig
from skrx.models.GRU4Rec import build_walker_schedule as jax_schedule
from skrx.models.GRU4Rec import device_walker_schedule
from skrx.models.GRU4Rec import walker_num_steps as jax_num_steps
from skrx.models.GRU4RecPlus import GRU4RecPlus as JaxGRU4RecPlus
from skrx.models.GRU4RecPlus import GRU4RecPlusConfig as JaxPlusConfig
from skrx.serve import TopKRecommender as JaxTopK
from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.convert import gru4rec_params_from_jax
from skrx_torch.eval import fused_family
from skrx_torch.models.GRU4Rec import (GRU4Rec, GRU4RecConfig,
                                       build_walker_schedule,
                                       walker_num_steps)
from skrx_torch.models.GRU4RecPlus import GRU4RecPlus, GRU4RecPlusConfig
from skrx_torch.serve import TopKRecommender

TOL = dict(rtol=1e-5, atol=1e-6)
RUN = dict(seed=1, metric=("NDCG", "Recall"), top_k=(5, 10),
           test_batch_size=16)
MODELS = {"GRU4Rec": (JaxGRU4Rec, GRU4Rec, JaxGRU4RecConfig, GRU4RecConfig),
          "GRU4RecPlus": (JaxGRU4RecPlus, GRU4RecPlus, JaxPlusConfig,
                          GRU4RecPlusConfig)}
SMALL = dict(layers=[8, 6], batch_size=5, lr=0.01, reg=0.01)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_data(root: str) -> str:
    """24 users x 40 items in time order: 2..14 training items a user and
    users 3, 9 and 17 with one (sessions of length 1 give the walker
    replace-only slots); two test items each."""
    rng = np.random.default_rng(5)
    train, test = [], []
    for u in range(24):
        n = 1 if u in (3, 9, 17) else int(rng.integers(2, 15))
        items = rng.permutation(40)
        train += [(u, int(i), 1, t) for t, i in enumerate(items[:n])]
        test += [(u, int(i), 1, 99) for i in items[n:n + 2]]
    name = "walk"
    out = os.path.join(root, name)
    os.makedirs(out, exist_ok=True)
    for suffix, rows in ((".train", train), (".test", test)):
        np.savetxt(os.path.join(out, name + suffix), np.array(rows),
                   fmt="%d", delimiter="\t")
    return out


@pytest.fixture(scope="module")
def build(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_gru4rec")
    data = _write_data(str(root))
    cache = {}

    def make(name, **over):
        key = (name,) + tuple(sorted(over.items()))
        if key not in cache:
            jcls, tcls, *_ = MODELS[name]
            cfg = dict(SMALL, **over)
            cwd = os.getcwd()
            os.chdir(root)
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


def _set_weights(jm, tm, rng):
    params = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, jm.params))
    jm.params = jax.tree_util.tree_map(jnp.asarray, params)
    tm.load_jax_params(params)
    return params


def _adam_state(jm, rng):
    """A random optax Adam state (count 3) for JAX, and (count, mu, nu)
    raveled in JAX's order for the port."""
    from jax.flatten_util import ravel_pytree
    flat, unravel = ravel_pytree(jm.params)
    mu = rng.standard_normal(flat.shape[0]).astype(np.float32) * 0.05
    nu = rng.uniform(1e-3, 1e-2, flat.shape[0]).astype(np.float32)
    state = tuple(
        s._replace(count=jnp.asarray(3, jnp.int32), mu=unravel(mu),
                   nu=unravel(nu)) if hasattr(s, "mu") else s
        for s in jm.opt_state)
    return state, (3, mu, nu)


def _sessions(rng, n, lo, hi):
    lens = rng.integers(lo, hi + 1, n)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    items = rng.integers(0, 50, offsets[-1]).astype(np.int32)
    return items, offsets, lens


@pytest.mark.parametrize("n,lo,hi,b", [(30, 1, 9, 4), (12, 1, 1, 4),
                                       (3, 2, 6, 5), (40, 1, 3, 7)])
def test_walker_schedule_matches_jax(n, lo, hi, b):
    """Length-1 sessions (replace-only slots, and none emitted at all when
    every session has length 1) and more rows than sessions."""
    rng = np.random.default_rng(n + b)
    items, offsets, lens = _sessions(rng, n, lo, hi)
    perm = rng.permutation(n)
    got = build_walker_schedule(items, offsets, perm, b)
    ref = jax_schedule(items, offsets, perm, b)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    slots, emitted = walker_num_steps(lens, perm, b)
    assert (slots, emitted) == jax_num_steps(lens, perm, b)
    assert emitted == got[0].shape[0]
    if emitted:
        ins, outs, resets, valid = device_walker_schedule(items, offsets,
                                                          perm, b, slots)
        np.testing.assert_array_equal(ins[valid], got[0])
        np.testing.assert_array_equal(outs[valid], got[1])
        np.testing.assert_array_equal(resets[valid].astype(bool), got[2])


def _jax_negatives(jm, epoch, slots, valid):
    """The negatives of each emitted step of JAX's epoch: its key split at
    every slot, the skipped ones included."""
    key = jax.random.fold_in(jax.random.key(jm._np_seed), epoch)
    negs = []
    for s in range(slots):
        key, sub = jax.random.split(key)
        if valid[s]:
            negs.append(torch.from_numpy(np.asarray(jax.random.categorical(
                sub, jm._neg_log_weights, shape=(jm.config.n_sample,))
            ).astype(np.int64)))
    return negs


@pytest.mark.parametrize("name,loss", [("GRU4Rec", "top1"),
                                       ("GRU4Rec", "bpr"),
                                       ("GRU4RecPlus", "bpr_max"),
                                       ("GRU4RecPlus", "top1_max")])
def test_epoch_matches_jax(build, name, loss):
    over = dict(loss=loss)
    if name == "GRU4RecPlus":
        over.update(n_sample=7)
    jm, tm = build(name, **over)
    rng = np.random.default_rng(3)
    params = _set_weights(jm, tm, rng)
    opt_state, flat_state = _adam_state(jm, rng)
    tm.load_jax_opt_state(*flat_state)
    epoch = 2
    perm = np.random.default_rng((1, epoch)).permutation(jm._n_sessions)
    slots, emitted = jax_num_steps(jm._sess_lens, perm, 5)
    assert emitted > 5 and slots > emitted       # replace-only slots too
    key = jax.random.fold_in(jax.random.key(jm._np_seed), epoch)
    p, jm.opt_state, ref_loss = jm._run_epoch(jm.params, opt_state,
                                   jnp.asarray(perm.astype(np.int32)), key,
                                   max(64, 2 ** int(np.ceil(np.log2(slots)))))
    if name == "GRU4RecPlus":
        _, _, _, valid = device_walker_schedule(jm._items_flat, jm._offsets,
                                                perm, 5, slots)
        negs = iter(_jax_negatives(jm, epoch, slots, valid))
        tm.draw_negatives = lambda gen: next(negs)
    jm.params = p                          # the epoch donates its inputs
    loss_ = tm._train_epoch(epoch)
    np.testing.assert_allclose(loss_, float(ref_loss), rtol=1e-5)
    ref = gru4rec_params_from_jax(jax.tree_util.tree_map(np.asarray, p))
    start = gru4rec_params_from_jax(params)
    got = dict(tm.named_parameters())
    assert set(got) == set(ref)
    for key_, value in ref.items():
        np.testing.assert_allclose(got[key_].detach().numpy(),
                                   value.numpy(), **TOL, err_msg=key_)
        assert not np.array_equal(value.numpy(), start[key_].numpy()), key_


@pytest.mark.parametrize("name", ["GRU4Rec", "GRU4RecPlus"])
def test_predict_routes_and_recommend_match_jax(build, name):
    jm, tm = build(name)
    _set_weights(jm, tm, np.random.default_rng(7))
    users = np.arange(tm.num_users)
    np.testing.assert_allclose(tm.predict(users).numpy(),
                               np.asarray(jm.predict(users)), **TOL)
    ref, got = jm.evaluate(), tm.evaluate()
    assert list(got.metrics()) == list(ref.metrics())
    np.testing.assert_allclose(list(got.values()), list(ref.values()),
                               rtol=0, atol=1e-6)
    ev = tm.evaluator
    for mode in ("fused", "chunked"):
        ev.eval_mode, ev.chunk_size = mode, 16
        try:
            np.testing.assert_allclose(list(tm.evaluate().values()),
                                       list(got.values()), rtol=0, atol=1e-6)
        finally:
            ev.eval_mode = "full"
    ids, vals = TopKRecommender(tm, k=6).recommend(users)
    ref_ids, ref_vals = JaxTopK(jm, k=6).recommend(users)
    np.testing.assert_array_equal(ids, np.asarray(ref_ids))
    np.testing.assert_allclose(vals, np.asarray(ref_vals), **TOL)
    fused = TopKRecommender(tm, k=6, fused="always")
    assert fused.fused
    f_ids, f_vals = fused.recommend(users)
    np.testing.assert_allclose(f_vals, vals, **TOL)
    # a step moves the parameters in place: the states are computed anew
    before = tm._user_states().clone()
    in_s, out_s, reset_s = tm.epoch_schedule(0)
    states = [torch.zeros((5, n)) for n in tm.config.layers]
    tm.train_step(in_s[0], out_s[0], states,
                  tm.draw_negatives(torch.Generator().manual_seed(0)))
    assert not torch.equal(before, tm._user_states())


def test_nonlinear_final_act_keeps_the_predict_route(build):
    jm, tm = build("GRU4Rec", final_act="relu")
    _set_weights(jm, tm, np.random.default_rng(9))
    assert fused_family(tm) is None
    users = np.arange(tm.num_users)
    scores = tm.predict(users).numpy()
    assert (scores >= 0).all() and (scores == 0).any()
    np.testing.assert_allclose(scores, np.asarray(jm.predict(users)), **TOL)
    server = TopKRecommender(tm, k=6, fused="always")
    assert server.fused is False                 # served through predict
    ids, _ = server.recommend(users)
    np.testing.assert_array_equal(ids, np.asarray(
        JaxTopK(jm, k=6).recommend(users)[0]))
    np.testing.assert_allclose(list(tm.evaluate().values()),
                               list(jm.evaluate().values()), rtol=0,
                               atol=1e-6)
    ev = tm.evaluator
    ev.eval_mode, ev.chunk_size = "chunked", 16
    try:
        np.testing.assert_allclose(list(tm.evaluate().values()),
                                   list(jm.evaluate().values()), rtol=0,
                                   atol=1e-6)
    finally:
        ev.eval_mode = "full"


@pytest.mark.parametrize("name", ["GRU4Rec", "GRU4RecPlus"])
def test_config_registry_converter_and_fit(build, name, tmp_path,
                                           monkeypatch):
    jm, tm = build(name)
    _, cls, jcfg_cls, cfg_cls = MODELS[name]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(RunConfig(data_dir=tm.dataset.data_dir), dict(SMALL))
    reg = ModelRegistry()
    reg.load_skrx_model(name)
    assert reg.get_model(name) == (cls, cfg_cls)
    defaults, ref = cfg_cls(), jcfg_cls()
    for field in defaults.to_dict():
        assert getattr(defaults, field) == getattr(ref, field), field
    for bad in (dict(loss="hinge"), dict(hidden_act="gelu"), dict(lr=1),
                dict(batch_size=0)):
        with pytest.raises(ValueError):
            cfg_cls(**bad)
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    with pytest.raises(ValueError):
        gru4rec_params_from_jax({k: v for k, v in params.items()
                                 if k != "item_bias"})
    with pytest.raises(ValueError):
        gru4rec_params_from_jax(dict(params,
                                     item_emb=params["item_emb"][:, :3]))
    monkeypatch.chdir(tmp_path)
    m = cls(RunConfig(data_dir=tm.dataset.data_dir, seed=1, top_k=(10,)),
            dict(SMALL, epochs=2), device="cpu")
    m.fit()
    losses = [h["loss"] for h in m.history]
    assert len(losses) == 2 and all(np.isfinite(losses))
