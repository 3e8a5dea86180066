"""BM3 and SLMRec in the port against the JAX package's, on the data of
``tests/test_models_mm.py`` (50 users, 80 items, 1,500 ratings, 12-d image
and 10-d text features) and the same weights, Adam state and batch. JAX
runs ``graph_impl="segment"``. BM3: the loss, gradient and one Adam step
under JAX's table-wide target masks, on a batch with a repeated user and
item. SLMRec: the five adjacencies; one step of each SSL task (FAC under
"concat" and "mean", FD and FD+FM under "concat", FM under "mean") with
JAX's draws (FD's masks, FM's tower indices); the sigmoid ``predict``; full evaluate() equal to JAX's, the
chunked route equal to the full one and the fused route refused. Values
within rtol 1e-5 / atol 1e-6, metrics within 1e-6. Config, registry,
converters, fit() with checkpoint and resume."""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import optax
import torch

from skrx import RunConfig as JaxRunConfig
from skrx.io import synthetic as jax_synthetic
from skrx.models.BM3 import BM3 as JaxBM3
from skrx.models.BM3 import BM3Config as JaxBM3Config
from skrx.models.SLMRec import SLMRec as JaxSLMRec
from skrx.models.SLMRec import SLMRecConfig as JaxSLMRecConfig
from skrx.models.SLMRec import _slmrec_adj
from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.convert import bm3_params_from_jax, slmrec_params_from_jax
from skrx_torch.eval import fused_family
from skrx_torch.models.BM3 import BM3, BM3Config, bm3_draws
from skrx_torch.models.SLMRec import (SLMRec, SLMRecConfig, slmrec_adj,
                                      slmrec_draws)
from skrx_torch.serve import TopKRecommender

DIM = 8
TOL = dict(rtol=1e-5, atol=1e-6)
RUN = dict(seed=1, metric=("NDCG", "Recall"), top_k=(5, 10),
           test_batch_size=16)
CFGS = {"BM3": dict(embed_dim=DIM, n_layers=2, lr=0.01, batch_size=32),
        "SLMRec": dict(rec_dim=DIM, layer_num=2, lr=0.01, batch_size=32,
                       ssl_alpha=0.5)}
JAX_MODELS = {"BM3": JaxBM3, "SLMRec": JaxSLMRec}
PORT_MODELS = {"BM3": BM3, "SLMRec": SLMRec}
CONVERT = {"BM3": bm3_params_from_jax, "SLMRec": slmrec_params_from_jax}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def build(tmp_path_factory):
    """(jax model, port model) of a name and config overrides, built once
    each."""
    root = tmp_path_factory.mktemp("torch_bm3_slmrec")
    data = jax_synthetic.make_dataset_dir(str(root), num_users=50,
                                          num_items=80, num_ratings=1500,
                                          seed=9, with_mm=True, img_dim=12,
                                          txt_dim=10)
    cache = {}

    def make(name, **over):
        key = (name, tuple(sorted(over.items())))
        if key not in cache:
            cwd = os.getcwd()
            os.chdir(root)                 # the models write log/ here
            try:
                cfg = dict(CFGS[name], **over)
                jm = JAX_MODELS[name](
                    JaxRunConfig(recommender=name, data_dir=data, **RUN),
                    dict(cfg, graph_impl="segment"))
                tm = PORT_MODELS[name](RunConfig(data_dir=data, **RUN), cfg,
                                       device="cpu")
            finally:
                os.chdir(cwd)
            cache[key] = (jm, tm)
        return cache[key]
    return make


def _set_weights(jm, tm, rng, scale=0.3):
    params = jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(np.shape(x)) * scale).astype(
            np.float32), jm.params)
    jm.params = jax.tree_util.tree_map(jnp.asarray, params)
    jm._final = None
    tm.load_jax_params(params)
    return params


def _adam(jm, tm, rng, count=3):
    """The same Adam state in both: JAX's at ``count`` with random moments,
    converted."""
    from jax.flatten_util import ravel_pytree
    flat, unravel = ravel_pytree(jm.params)
    mu = rng.standard_normal(flat.shape[0]).astype(np.float32) * 0.05
    nu = rng.uniform(1e-3, 1e-2, flat.shape[0]).astype(np.float32)
    adam, *rest = jm.optimizer.init(jm.params)
    tm.load_jax_opt_state(count, mu, nu)
    return (adam._replace(count=jnp.asarray(count, jnp.int32),
                          mu=unravel(mu), nu=unravel(nu)), *rest)


def _batch(rng, jm, b=32):
    users = rng.integers(0, jm.num_users, b)
    items = rng.integers(0, jm.num_items, b)
    users[1], items[3] = users[0], items[2]        # repeated rows
    w = (rng.random(b) < 0.9).astype(np.float32)
    w[0] = w[1] = 1.0
    return users, items, w


def _jax_step(jm, opt, key, batch):
    return jax.jit(jm._step_with_key)((jm.params, opt, key), tuple(
        jnp.asarray(x.astype(np.int32) if x.dtype != np.float32 else x)
        for x in batch))


def _jax_grads(jm, key, batch):
    """JAX's gradient of the step's loss: its step under
    ``optax.identity``, whose update is the gradient."""
    real = jm.optimizer
    jm.optimizer = optax.identity()
    try:
        (new, _, _), loss = _jax_step(jm, (), key, batch)
    finally:
        jm.optimizer = real
    grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                   new, jm.params)
    return float(loss), grads


def _check_params(tm, ref_params, convert):
    ref = convert(jax.tree_util.tree_map(np.asarray, ref_params))
    got = dict(tm.named_parameters())
    assert set(got) == set(ref)
    for name, value in ref.items():
        np.testing.assert_allclose(got[name].detach().numpy(), value.numpy(),
                                   **TOL, err_msg=name)


# ------------------------------------------------------------------- BM3

def _bm3_jax_draws(key, jm):
    """JAX's target masks of the step with ``key``: the step splits the
    carry's key, the loss splits the subkey in four (users, items, text,
    image), each a Bernoulli over its whole table."""
    _, sub = jax.random.split(key)
    keys = jax.random.split(sub, 4)
    shapes = [(jm.num_users, DIM)] + [(jm.num_items, DIM)] * 3
    return tuple(torch.from_numpy(np.array(jax.random.bernoulli(
        k, 1 - jm.config.dropout, s))) for k, s in zip(keys, shapes))


def test_bm3_gradient_and_step_match_jax(build):
    """The loss and every parameter's gradient (autograd of ``_loss`` under
    JAX's masks), then one Adam step at count 3, on a batch where a user
    and an item appear twice (they share their mask row)."""
    jm, tm = build("BM3")
    rng = np.random.default_rng(11)
    _set_weights(jm, tm, rng)
    batch = _batch(rng, jm)
    key = jax.random.key(5)
    draws = _bm3_jax_draws(key, jm)
    ref_loss, ref_grads = _jax_grads(jm, key, batch)
    tm.zero_grad()
    loss = tm._loss(*(torch.from_numpy(x) for x in batch), draws)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), ref_loss, rtol=1e-5)
    grads = {n: p.grad for n, p in tm.named_parameters()}
    for name, ref in bm3_params_from_jax(ref_grads).items():
        np.testing.assert_allclose(grads[name].numpy(), ref.numpy(),
                                   **TOL, err_msg=name)
    tm.zero_grad()
    opt = _adam(jm, tm, rng)
    (new, _, _), ref_step = _jax_step(jm, opt, key, batch)
    got = tm.train_step((*(torch.from_numpy(x) for x in batch), draws))
    np.testing.assert_allclose(float(got), float(ref_step), rtol=1e-5)
    _check_params(tm, new, bm3_params_from_jax)
    _set_weights(jm, tm, rng)


def test_bm3_draws_contract(build):
    """Keep masks over whole tables (users, items, text, image) at 1 -
    dropout; a table-wide row is what a repeated id shares; none at
    dropout 0; the epoch's step generator drives them."""
    jm, tm = build("BM3")
    gen = torch.Generator().manual_seed(3)
    draws = bm3_draws(gen, 50, 80, DIM, 0.3, True, True)
    assert [tuple(d.shape) for d in draws] == [(50, DIM)] + [(80, DIM)] * 3
    assert all(d.dtype == torch.bool for d in draws)
    rate = float(torch.cat([d.reshape(-1) for d in draws]).float().mean())
    assert abs(rate - 0.7) < 0.05
    assert bm3_draws(gen, 50, 80, DIM, 0.3, False, True)[2] is None
    assert bm3_draws(gen, 50, 80, DIM, 0.0, True, True) == (None,) * 4
    seen = []
    real = tm.step_draws
    tm.step_draws = lambda: seen.append(real()) or seen[-1]
    try:
        assert np.isfinite(tm._train_epoch(0))
    finally:
        del tm.step_draws
    assert len(seen) == tm.pipeline.num_batches


def test_bm3_predict_and_evaluate_match_jax(build):
    jm, tm = build("BM3")
    _set_weights(jm, tm, np.random.default_rng(8), 0.5)
    users = np.arange(jm.num_users)
    ref = np.asarray(jm.predict(users))
    np.testing.assert_allclose(tm.predict(users).numpy(), ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())
    ref, got = jm.evaluate(), tm.evaluate()
    assert list(got.metrics()) == list(ref.metrics())
    np.testing.assert_allclose(list(got.values()), list(ref.values()),
                               rtol=0, atol=1e-6)
    ev = tm.evaluator
    for mode in ("fused", "chunked"):
        ev.eval_mode, ev.chunk_size = mode, 32
        try:
            np.testing.assert_allclose(list(tm.evaluate().values()),
                                       list(got.values()), rtol=0, atol=1e-6)
        finally:
            ev.eval_mode = "full"


# ---------------------------------------------------------------- SLMRec

def test_slmrec_adjacencies_match_jax(build):
    _, tm = build("SLMRec")
    pairs = tm.dataset.train_data.to_user_item_pairs()
    for adj_type in ("plain", "norm", "gcmc", "pre", "mean"):
        got = slmrec_adj(pairs, tm.num_users, tm.num_items, adj_type)
        ref = _slmrec_adj(pairs, tm.num_users, tm.num_items,
                          adj_type).tocsr()
        ref.sort_indices()
        np.testing.assert_array_equal(got.indptr, ref.indptr)
        np.testing.assert_array_equal(got.indices, ref.indices)
        np.testing.assert_array_equal(got.data, ref.data)
    with pytest.raises(ValueError):
        slmrec_adj(pairs, tm.num_users, tm.num_items, "sym")


def _slmrec_jax_draws(key, cfg, num_nodes):
    """JAX's draws of the step with ``key``: the subkey splits into k1, k2
    (the branches) and km (FM); each branch key into the ids, image and
    text towers, each tower's key split once a layer; FM's first tower a
    randint of km, the second one of 1 + randint of fold_in(km, 1) past
    it."""
    _, sub = jax.random.split(key)
    k1, k2, km = jax.random.split(sub, 3)
    fd = fm = None
    if cfg.ssl_task in ("FD", "FD+FM"):
        fd = []
        for kb in (k1, k2):
            towers = []
            for kt in jax.random.split(kb, 3):
                layers = []
                for _ in range(cfg.layer_num):
                    kt, s = jax.random.split(kt)
                    layers.append(torch.from_numpy(np.array(
                        jax.random.bernoulli(s, 1 - cfg.dropout_rate,
                                             (num_nodes, DIM)))))
                towers.append(layers)
            fd.append(towers)
    if cfg.ssl_task in ("FM", "FD+FM"):
        idx1 = jax.random.randint(km, (), 0, 3)
        idx2 = jnp.mod(idx1 + 1 + jax.random.randint(
            jax.random.fold_in(km, 1), (), 0, 2), 3)
        fm = (torch.tensor(int(idx1)), torch.tensor(int(idx2)))
    return fd, fm


@pytest.mark.parametrize("task,fusion", [
    ("FAC", "concat"), ("FAC", "mean"), ("FD", "concat"), ("FM", "mean"),
    ("FD+FM", "concat")])
def test_slmrec_step_matches_jax(build, task, fusion):
    jm, tm = build("SLMRec", ssl_task=task, mm_fusion_mode=fusion)
    rng = np.random.default_rng(12)
    _set_weights(jm, tm, rng)
    opt = _adam(jm, tm, rng)
    batch = _batch(rng, jm)
    key = jax.random.key(6)
    draws = _slmrec_jax_draws(key, tm.config, tm.num_users + tm.num_items)
    if task != "FAC":
        assert (draws[0] is None) == (task == "FM")
        assert (draws[1] is None) == (task == "FD")
    (new, _, _), ref = _jax_step(jm, opt, key, batch)
    got = tm.train_step((*(torch.from_numpy(x) for x in batch), draws))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    _check_params(tm, new, slmrec_params_from_jax)


def test_slmrec_draws_contract(build):
    """FD: 2 branches x 3 towers x layer_num masks at 1 - dropout_rate; FM:
    two distinct towers in [0, 3), each pair drawn; FAC draws nothing."""
    _, tm = build("SLMRec")
    gen = torch.Generator().manual_seed(4)
    cfg = SLMRecConfig(**dict(CFGS["SLMRec"], ssl_task="FD+FM"))
    pairs = set()
    for _ in range(60):
        fd, (i1, i2) = slmrec_draws(gen, cfg, 130)
        assert len(fd) == 2 and all(len(t) == 3 for t in fd)
        assert all(m.shape == (130, DIM) and m.dtype == torch.bool
                   for b in fd for t in b for m in t)
        assert 0 <= int(i1) < 3 and 0 <= int(i2) < 3 and int(i1) != int(i2)
        pairs.add((int(i1), int(i2)))
    assert len(pairs) == 6
    assert slmrec_draws(gen, SLMRecConfig(), 130) == (None, None)


def test_slmrec_predict_routes_and_evaluate(build):
    """``predict`` is sigmoid(u . i) as JAX's; full evaluate() equals
    JAX's; chunked equals full; the fused route is refused (its score is
    not a dot) and serving keeps predict."""
    jm, tm = build("SLMRec", mm_fusion_mode="mean")
    _set_weights(jm, tm, np.random.default_rng(9), 1.0)
    users = np.arange(jm.num_users)
    scores = tm.predict(users)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jm.predict(users)),
                               **TOL)
    u_all, i_all = tm._chunk_embeddings()
    np.testing.assert_allclose(scores.numpy(),
                               torch.sigmoid(u_all @ i_all.T).numpy(), **TOL)
    ref, got = jm.evaluate(), tm.evaluate()
    np.testing.assert_allclose(list(got.values()), list(ref.values()),
                               rtol=0, atol=1e-6)
    ev = tm.evaluator
    ev.eval_mode, ev.chunk_size = "chunked", 32
    try:
        np.testing.assert_allclose(list(tm.evaluate().values()),
                                   list(got.values()), rtol=0, atol=1e-6)
    finally:
        ev.eval_mode = "full"
    assert fused_family(tm) is None
    server = TopKRecommender(tm, k=5, fused="always")
    assert not server.fused
    ids, _ = server.recommend([0, 1])
    assert ids.shape == (2, 5)
    with pytest.raises(TypeError):
        SLMRec(RunConfig(data_dir=tm.dataset.data_dir, eval_mode="fused",
                         **RUN), CFGS["SLMRec"], device="cpu")


# ----------------------------------------------------------------- both

@pytest.mark.parametrize("name", ["BM3", "SLMRec"])
def test_config_registry_converter_and_fit(build, name, tmp_path,
                                           monkeypatch):
    jm, tm = build(name)
    cfg_cls = {"BM3": (BM3Config, JaxBM3Config),
               "SLMRec": (SLMRecConfig, JaxSLMRecConfig)}[name]
    reg = ModelRegistry()
    reg.load_skrx_model(name)
    cls, got_cfg = reg.get_model(name)
    assert cls is PORT_MODELS[name] and got_cfg is cfg_cls[0]
    defaults, ref = cfg_cls[0](), cfg_cls[1]()
    for field in defaults.to_dict():
        assert getattr(defaults, field) == getattr(ref, field), field
    assert cfg_cls[0].param_space() == cfg_cls[1].param_space()
    for bad in (dict(lr=1), dict(graph_impl="dense"), dict(batch_size=0)):
        with pytest.raises(ValueError):
            cfg_cls[0](**bad)
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    out = CONVERT[name](params)
    assert set(out) == {n for n, _ in tm.named_parameters()}
    params["user_emb"] = params["user_emb"][:, :3]
    with pytest.raises(ValueError):
        CONVERT[name](params)
    monkeypatch.chdir(tmp_path)
    if not torch.cuda.is_available():      # the default device is CUDA
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(RunConfig(data_dir=tm.dataset.data_dir), CFGS[name])
    run = dict(data_dir=tm.dataset.data_dir, seed=1, top_k=(10,),
               checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1)
    m = cls(RunConfig(**run), dict(CFGS[name], epochs=2), device="cpu")
    m.fit()
    losses = [h["loss"] for h in m.history]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert m._final_emb is not None        # frozen by the last evaluate()
    resumed = cls(RunConfig(**run, resume=True), dict(CFGS[name], epochs=3),
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
    for key, value in m.named_parameters():
        assert torch.equal(state[key], value.detach()), key
