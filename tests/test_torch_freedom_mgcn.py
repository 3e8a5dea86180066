"""FREEDOM and MGCN in the port against the JAX package's, on the data of
``tests/test_models_mm.py`` (50 users, 80 items, 1,500 ratings, 12-d image
and 10-d text features) and the same weights, Adam state and batches. JAX
runs ``graph_impl="segment"`` (FREEDOM's pruned edge list rebuilt from the
kept pairs); its "mxu" route gives the pruned mask that the port holds.
FREEDOM: the mask from JAX's keep indices equal to JAX's
``pruned_state``, the loss and steps under it. MGCN: its four graphs, the
loss and steps, a padded batch's InfoNCE, and the LambdaLR decay across
three epochs of update counts against optax. predict and evaluate() equal
to JAX's, the fused and chunked routes equal to the full one. Values
within rtol 1e-5 / atol 1e-6, metrics within 1e-6. Config, registry,
converters, fit() with checkpoint and resume."""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from skrx import RunConfig as JaxRunConfig
from skrx.io import synthetic as jax_synthetic
from skrx.models.FREEDOM import FREEDOM as JaxFREEDOM
from skrx.models.FREEDOM import FREEDOMConfig as JaxFREEDOMConfig
from skrx.models.MGCN import MGCN as JaxMGCN
from skrx.models.MGCN import MGCNConfig as JaxMGCNConfig
from skrx.ops.sampling import gumbel_topk_without_replacement
from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.convert import freedom_params_from_jax, mgcn_params_from_jax
from skrx_torch.models.FREEDOM import FREEDOM, FREEDOMConfig
from skrx_torch.models.MGCN import MGCN, MGCNConfig, mgcn_info_nce, mgcn_lr
from skrx_torch.models.pipeline import epoch_generator

DIM = 8
TOL = dict(rtol=1e-5, atol=1e-6)
RUN = dict(seed=1, metric=("NDCG", "Recall"), top_k=(5, 10),
           test_batch_size=16)
CFGS = {"FREEDOM": dict(embed_dim=DIM, feat_dim=DIM, knn_k=5, lr=0.01,
                        batch_size=32, dropout=0.5, reg=0.1),
        "MGCN": dict(embed_dim=DIM, knn_k=5, lr=0.01, batch_size=32,
                     cl_loss=0.5, reg=0.1, lr_scheduler=[0.5, 2])}
JAX_MODELS = {"FREEDOM": JaxFREEDOM, "MGCN": JaxMGCN}
PORT_MODELS = {"FREEDOM": FREEDOM, "MGCN": MGCN}
CONVERT = {"FREEDOM": freedom_params_from_jax, "MGCN": mgcn_params_from_jax}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def build(tmp_path_factory):
    """(jax model, port model) of a name, built once each; ``impl`` picks
    the JAX model's graph_impl."""
    root = tmp_path_factory.mktemp("torch_freedom_mgcn")
    data = jax_synthetic.make_dataset_dir(str(root), num_users=50,
                                          num_items=80, num_ratings=1500,
                                          seed=9, with_mm=True, img_dim=12,
                                          txt_dim=10)
    cache = {}

    def make(name, impl="segment"):
        if (name, impl) not in cache:
            cwd = os.getcwd()
            os.chdir(root)                 # the models write log/ here
            try:
                jm = JAX_MODELS[name](
                    JaxRunConfig(recommender=name, data_dir=data, **RUN),
                    dict(CFGS[name], graph_impl=impl))
                tm = PORT_MODELS[name](RunConfig(data_dir=data, **RUN),
                                       CFGS[name], device="cpu")
            finally:
                os.chdir(cwd)
            cache[name, impl] = (jm, tm)
        return cache[name, impl]
    return make


def _random_params(jm, rng, scale=0.3):
    return jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(np.shape(x)) * scale).astype(
            np.float32), jm.params)


def _set_weights(jm, tm, rng, scale=0.3):
    params = _random_params(jm, rng, scale)
    jm.params = jax.tree_util.tree_map(jnp.asarray, params)
    jm._final = None
    if getattr(jm, "_use_flat", False):
        from jax.flatten_util import ravel_pytree
        jm._flat = ravel_pytree(jm.params)[0]
    tm.load_jax_params(params)
    return params


def _moments(n, rng):
    return (rng.standard_normal(n).astype(np.float32) * 0.05,
            rng.uniform(1e-3, 1e-2, n).astype(np.float32))


def _batches(rng, jm, count, b=32):
    out = []
    for _ in range(count):
        w = (rng.random(b) < 0.9).astype(np.float32)
        w[-3:] = 0.0                                 # padded rows
        out.append((rng.integers(0, jm.num_users, b),
                    rng.integers(0, jm.num_items, b),
                    rng.integers(0, jm.num_items, (b, 1)), w))
    return out


def _jax_batch(batch):
    return tuple(jnp.asarray(x.astype(np.int32) if x.dtype != np.float32
                             else x) for x in batch)


def _check_params(tm, ref_params, convert):
    ref = convert(jax.tree_util.tree_map(np.asarray, ref_params))
    got = dict(tm.named_parameters())
    assert set(got) == set(ref)
    for name, value in ref.items():
        np.testing.assert_allclose(got[name].detach().numpy(), value.numpy(),
                                   **TOL, err_msg=name)


def _check_predict_and_evaluate(jm, tm, rng):
    _set_weights(jm, tm, rng, 0.5)
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


# --------------------------------------------------------------- FREEDOM

def test_freedom_mask_from_jax_keep_equals_pruned_state(build):
    """JAX's kept pairs (its Gumbel top-k of the key) as the port's mask
    equal JAX's "mxu" ``pruned_state`` of the same key: keep_len nonzero
    pairs, both halves alike; the port's own epochs keep keep_len
    distinct pairs from stream 1 of (seed + 1, epoch)."""
    jx, tm = build("FREEDOM", "mxu")
    for seed in (3, 4):
        key = jax.random.key(seed)
        keep = gumbel_topk_without_replacement(
            key, jnp.log(jnp.asarray(tm._base.numpy())), tm.keep_len)
        mask = tm.mask_from_keep(torch.from_numpy(
            np.asarray(keep).astype(np.int64)))
        ref = np.asarray(jx._pruned_edges(key))
        np.testing.assert_allclose(mask.numpy(), ref, **TOL)
        e = tm.num_pairs
        assert int((mask[:e] != 0).sum()) == tm.keep_len
        assert torch.equal(mask[:e], mask[e:])
    assert tm.keep_len == int(tm.num_pairs * 0.5)
    mask = tm.epoch_mask(1)
    gen = epoch_generator(2, 1, torch.device("cpu"), stream=1)
    keep = torch.topk(tm._log_base - torch.log(-torch.log(
        torch.rand(tm._log_base.shape, generator=gen).clamp_(min=1e-20))),
        tm.keep_len).indices
    assert torch.equal(mask, tm.mask_from_keep(keep))
    assert not torch.equal(mask, tm.epoch_mask(2))


def test_freedom_steps_match_jax(build):
    """Two steps under one pruning (JAX's pruned edge list of a key, the
    port's mask of the same kept pairs), each loss and the parameters
    after it."""
    jm, tm = build("FREEDOM")
    rng = np.random.default_rng(21)
    _set_weights(jm, tm, rng)
    from jax.flatten_util import ravel_pytree
    flat, unravel = ravel_pytree(jm.params)
    mu, nu = _moments(flat.shape[0], rng)
    adam, *rest = jm.optimizer.init(jm.params)
    opt = (adam._replace(count=jnp.asarray(3, jnp.int32), mu=unravel(mu),
                         nu=unravel(nu)), *rest)
    tm.load_jax_opt_state(3, mu, nu)
    key = jax.random.key(3)
    keep = gumbel_topk_without_replacement(
        key, jnp.log(jnp.asarray(tm._base.numpy())), tm.keep_len)
    mask = tm.mask_from_keep(torch.from_numpy(np.asarray(keep).astype(
        np.int64)))
    carry = (jm.params, opt, jm._pruned_edges(key))
    step = jax.jit(jm._train_step)
    for batch in _batches(rng, jm, 2):
        carry, ref = step(carry, _jax_batch(batch))
        got = tm.train_step((*(torch.from_numpy(x) for x in batch), mask))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
        _check_params(tm, carry[0], freedom_params_from_jax)


def test_freedom_predict_and_evaluate_match_jax(build):
    jm, tm = build("FREEDOM")
    _check_predict_and_evaluate(jm, tm, np.random.default_rng(22))


# ------------------------------------------------------------------ MGCN

def _coo_of(graph, n_rows, n_cols):
    """The operator of a port Graph as a dense (rows, cols) matrix."""
    seg = graph.fwd
    out = np.zeros((n_rows, n_cols))
    np.add.at(out, (seg.dst.numpy(), seg.src.numpy()), seg.weight.numpy())
    return out


def _dense(src, dst, vals, n_rows, n_cols):
    out = np.zeros((n_rows, n_cols))
    np.add.at(out, (np.asarray(dst), np.asarray(src)), np.asarray(vals))
    return out


def test_mgcn_four_graphs_match_jax(build):
    jm, tm = build("MGCN")
    u, n = tm.num_users, tm.num_items
    g = tm.graphs
    np.testing.assert_allclose(_coo_of(g.adj, u + n, u + n),
                               _dense(*jm._adj, u + n, u + n), **TOL)
    np.testing.assert_allclose(_coo_of(g.R, u, n), _dense(*jm._R, u, n),
                               **TOL)
    assert (g.R.num_nodes, g.R.num_src_nodes) == (u, n)
    for got, (rows, cols, vals) in ((g.image, jm._img_adj),
                                    (g.text, jm._txt_adj)):
        np.testing.assert_allclose(_coo_of(got, n, n),
                                   _dense(cols, rows, vals, n, n), **TOL)
        assert got.num_edges == len(rows) == 5 * n
    cached = sorted(os.listdir(os.path.join(tm.dataset.data_dir,
                                            "_data_cache")))
    assert "torch_image_mgcn_adj_5.npz" in cached
    assert "torch_text_mgcn_adj_5.npz" in cached


def test_mgcn_padded_info_nce():
    """A padded row (weight 0) changes no other row's term: the InfoNCE
    of a batch equals that of its valid rows alone."""
    gen = torch.Generator().manual_seed(5)
    v1, v2 = torch.randn(12, 6, generator=gen), torch.randn(12, 6,
                                                            generator=gen)
    w = torch.ones(12)
    w[9:] = 0.0
    padded = mgcn_info_nce(v1, v2, 0.2, w)
    alone = mgcn_info_nce(v1[:9], v2[:9], 0.2, torch.ones(9))
    np.testing.assert_allclose(float(padded), float(alone), rtol=1e-6)
    v1[9:] *= 1e3                          # padded rows' values do not enter
    np.testing.assert_allclose(float(mgcn_info_nce(v1, v2, 0.2, w)),
                               float(alone), rtol=1e-6)


def _mgcn_opt(jm, tm, count, rng):
    from jax.flatten_util import ravel_pytree
    flat, unravel = ravel_pytree(jm.params)
    mu, nu = _moments(flat.shape[0], rng)
    adam, sched = jm.optimizer.init(flat)
    tm.load_jax_opt_state(count, mu, nu)
    c = jnp.asarray(count, jnp.int32)
    return flat, unravel, (adam._replace(count=c, mu=mu, nu=nu),
                           sched._replace(count=c))


def test_mgcn_steps_and_lambda_lr_match_optax(build):
    """Two steps (batches with padded rows) starting at update counts
    across three epochs of ``spe`` steps: the loss and every parameter
    agree with JAX's flat optax Adam under its LambdaLR schedule, so the
    learning rate of each count does; ``update_count`` follows optax's
    count."""
    jm, tm = build("MGCN")
    spe = tm.pipeline.num_batches
    assert spe == jm.pipeline.num_batches and spe >= 2
    step = jax.jit(jm._train_step)
    rng = np.random.default_rng(31)
    for count in (0, spe - 1, 2 * spe, 3 * spe - 1):
        _set_weights(jm, tm, rng)
        flat, unravel, opt = _mgcn_opt(jm, tm, count, rng)
        carry = (flat, opt)
        for i, batch in enumerate(_batches(rng, jm, 2)):
            assert tm.update_count == count + i
            carry, ref = step(carry, _jax_batch(batch))
            got = tm.train_step(tuple(torch.from_numpy(x) for x in batch))
            np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
            _check_params(tm, unravel(carry[0]), mgcn_params_from_jax)
        assert int(carry[1][0].count) == tm.update_count == count + 2
    rate, period = CFGS["MGCN"]["lr_scheduler"]
    for count in range(3 * spe + 1):
        assert tm.lr_at(count) == 0.01 * rate ** ((count // spe) / period)
    assert mgcn_lr(1.0, 0.96, 50, 10, 25) == 0.96 ** (2 / 50)


def test_mgcn_predict_and_evaluate_match_jax(build):
    jm, tm = build("MGCN")
    _check_predict_and_evaluate(jm, tm, np.random.default_rng(32))


# ----------------------------------------------------------------- both

@pytest.mark.parametrize("name", ["FREEDOM", "MGCN"])
def test_config_registry_converter_and_fit(build, name, tmp_path,
                                           monkeypatch):
    jm, tm = build(name)
    cfg_cls = {"FREEDOM": (FREEDOMConfig, JaxFREEDOMConfig),
               "MGCN": (MGCNConfig, JaxMGCNConfig)}[name]
    reg = ModelRegistry()
    reg.load_skrx_model(name)
    cls, got_cfg = reg.get_model(name)
    assert cls is PORT_MODELS[name] and got_cfg is cfg_cls[0]
    defaults, ref = cfg_cls[0](), cfg_cls[1]()
    for field in defaults.to_dict():
        assert getattr(defaults, field) == getattr(ref, field), field
    assert cfg_cls[0].param_space() == cfg_cls[1].param_space()
    for bad in (dict(lr=1), dict(graph_impl="dense"), dict(knn_k=0)):
        with pytest.raises(ValueError):
            cfg_cls[0](**bad)
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    out = CONVERT[name](params)
    assert set(out) == {n for n, _ in tm.named_parameters()}
    params["item_emb"] = params["item_emb"][:-1]
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
    resumed = cls(RunConfig(**run, resume=True), dict(CFGS[name], epochs=3),
                  device="cpu")
    state = {}
    first = resumed._train_epoch

    def snapshot(epoch):
        state.update({k: v.detach().clone()
                      for k, v in resumed.named_parameters()})
        state["count"] = getattr(resumed, "update_count", None)
        return first(epoch)
    resumed._train_epoch = snapshot
    resumed.fit()
    assert [h["epoch"] for h in resumed.history] == [2]
    for key, value in m.named_parameters():
        assert torch.equal(state[key], value.detach()), key
    assert state["count"] == getattr(m, "update_count", None)
