"""LATTICE in the port against the JAX package's, on the data of
``tests/test_models_mm.py`` (50 users, 80 items, 1,500 ratings, 12-d image
and 10-d text features; a copy with the image table alone) and the same
weights, Adam state and batches. JAX runs ``graph_impl="segment"`` and
holds its item graph dense; the port holds it as edges. The sparse graph
equal to JAX's dense ``build_item_adj`` (nonzeros and zeros) with one
modality and with two; the first batch's gradient through the learned
graph into ``image_trs``, ``text_trs``, the feature tables and
``modal_weight``; the first and a later step (on the detached graph) for
"lightgcn", "ngcf" (under JAX's dropout masks) and "mf"; predict and
evaluate(), which selects the graph again, equal to JAX's; the fused and
chunked routes equal to the full one. Values within rtol 1e-5 / atol
1e-6, metrics within 1e-6. Config, registry, converter, fit() with
checkpoint and resume."""
import os
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import optax
import torch

from skrx import RunConfig as JaxRunConfig
from skrx.io import synthetic as jax_synthetic
from skrx.models.LATTICE import LATTICE as JaxLATTICE
from skrx.models.LATTICE import LATTICEConfig as JaxLATTICEConfig
from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.convert import lattice_params_from_jax
from skrx_torch.models.LATTICE import (LATTICE, LATTICEConfig,
                                       lattice_draws, lattice_item_weights,
                                       lattice_loss)

DIM = 8
TOL = dict(rtol=1e-5, atol=1e-6)
RUN = dict(seed=1, metric=("NDCG", "Recall"), top_k=(5, 10),
           test_batch_size=16)
CFG = dict(embed_dim=DIM, feat_embed_dim=DIM, weight_size=[DIM, DIM],
           knn_k=5, lr=0.01, batch_size=32, lambda_coeff=0.5, reg=0.1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def build(tmp_path_factory):
    """(jax model, port model) of config overrides, on the two-modality
    data or (``image_only``) its copy without the text table."""
    root = tmp_path_factory.mktemp("torch_lattice")
    data = jax_synthetic.make_dataset_dir(str(root), num_users=50,
                                          num_items=80, num_ratings=1500,
                                          seed=9, with_mm=True, img_dim=12,
                                          txt_dim=10)
    name = os.path.basename(data)
    lone = os.path.join(str(root), "image_only", name)
    shutil.copytree(data, lone)
    os.remove(os.path.join(lone, f"{name}.txt.npz"))
    cache = {}

    def make(image_only=False, **over):
        key = (image_only, tuple(sorted(over.items())))
        if key not in cache:
            cwd = os.getcwd()
            os.chdir(root)                 # the models write log/ here
            try:
                path = lone if image_only else data
                cfg = dict(CFG, **over)
                jm = JaxLATTICE(JaxRunConfig(recommender="LATTICE",
                                             data_dir=path, **RUN),
                                dict(cfg, graph_impl="segment"))
                tm = LATTICE(RunConfig(data_dir=path, **RUN), cfg,
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
    params["modal_weight"] = np.array([0.3, -0.2], np.float32)
    jm.params = jax.tree_util.tree_map(jnp.asarray, params)
    jm._final = None
    tm.load_jax_params(params)
    return params


def _adam(jm, tm, rng, count=3):
    from jax.flatten_util import ravel_pytree
    flat, unravel = ravel_pytree(jm.params)
    mu = rng.standard_normal(flat.shape[0]).astype(np.float32) * 0.05
    nu = rng.uniform(1e-3, 1e-2, flat.shape[0]).astype(np.float32)
    adam, *rest = jm.optimizer.init(jm.params)
    tm.load_jax_opt_state(count, mu, nu)
    return (adam._replace(count=jnp.asarray(count, jnp.int32),
                          mu=unravel(mu), nu=unravel(nu)), *rest)


def _batch(rng, jm, b=32):
    w = (rng.random(b) < 0.9).astype(np.float32)
    w[-2:] = 0.0                                    # padded rows
    return (rng.integers(0, jm.num_users, b), rng.integers(0, jm.num_items, b),
            rng.integers(0, jm.num_items, (b, 1)), w)


def _jax_batch(batch):
    return tuple(jnp.asarray(x.astype(np.int32) if x.dtype != np.float32
                             else x) for x in batch)


def _jax_masks(key, cfg, num_nodes):
    """ngcf's dropout masks of JAX's step with carry key ``key``: the step
    splits the key, the forward splits the subkey once a layer of rate >
    0."""
    if cfg.cf_model != "ngcf":
        return None
    _, sub = jax.random.split(key)
    masks = []
    for width, rate in zip(cfg.weight_size, cfg.mess_dropout):
        if rate <= 0:
            masks.append(None)
            continue
        sub, s = jax.random.split(sub)
        masks.append(torch.from_numpy(np.array(jax.random.bernoulli(
            s, 1 - rate, (num_nodes, width)))))
    return masks


def _dense_of(tm, weights):
    item = tm.item_graph()
    if weights is None:
        weights = lattice_item_weights(tm.params_tree(), tm.config, item)
    g = item.graph
    out = np.zeros((tm.num_items, tm.num_items))
    np.add.at(out, (g.dst.numpy(), g.src.numpy()),
              weights.detach().numpy())
    return out


@pytest.mark.parametrize("image_only", [False, True])
def test_sparse_item_graph_equals_jax_dense(build, image_only):
    """The learned blend and the originals, as edges, scattered into an
    (N, N) matrix equal JAX's dense ``build_item_adj``: the same nonzeros,
    zeros elsewhere; 4k edges a row with two modalities, 2k with one."""
    jm, tm = build(image_only)
    _set_weights(jm, tm, np.random.default_rng(1))
    ref = np.asarray(jm._build_item_adj(jm.params))
    got = _dense_of(tm, None)
    assert np.array_equal(got != 0, ref != 0)
    np.testing.assert_allclose(got, ref, **TOL)
    modalities = 1 if image_only else 2
    assert tm.item_graph().graph.graph.num_edges \
        == 2 * modalities * 5 * tm.num_items
    assert ("t_feat" in dict(tm.named_parameters())) != image_only


def test_first_batch_gradient_through_the_learned_graph(build):
    """The epoch's first batch builds the weights with gradient: the
    gradients of the projectors, feature tables and ``modal_weight`` (and
    every other parameter) equal JAX's through its dense graph."""
    jm, tm = build()
    rng = np.random.default_rng(2)
    _set_weights(jm, tm, rng)
    batch = _batch(rng, jm)
    real = jm.optimizer
    jm.optimizer = optax.identity()
    try:
        carry = (jm.params, (), jnp.zeros((tm.num_items,) * 2),
                 jnp.asarray(True), jax.random.key(3))
        (new, *_), ref_loss = jax.jit(jm._step_full)(carry, _jax_batch(batch))
    finally:
        jm.optimizer = real
    ref = lattice_params_from_jax(jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b), new, jm.params))
    tm.zero_grad()
    item = tm.item_graph()
    loss, weights = lattice_loss(tm.ui_graph, item, tm.params_tree(),
                                 tm.config,
                                 *(torch.from_numpy(x) for x in batch), None)
    assert weights.requires_grad
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-5)
    grads = {n: p.grad for n, p in tm.named_parameters()}
    for name in ("image_trs.w", "image_trs.b", "text_trs.w", "text_trs.b",
                 "modal_weight", "v_feat", "t_feat"):
        assert float(grads[name].abs().max()) > 0, name
    for name, value in ref.items():
        np.testing.assert_allclose(grads[name].numpy(), value.numpy(), **TOL,
                                   err_msg=name)
    tm.zero_grad()


@pytest.mark.parametrize("cf_model", ["lightgcn", "ngcf", "mf"])
def test_first_and_later_steps_match_jax(build, cf_model):
    """The first step of an epoch (the graph with gradient, from the
    parameters before it) and a later one (its weights detached), each
    loss and every parameter after it; ngcf under JAX's masks."""
    jm, tm = build(cf_model=cf_model)
    rng = np.random.default_rng(4)
    _set_weights(jm, tm, rng)
    opt = _adam(jm, tm, rng)
    carry = (jm.params, opt, jnp.zeros((tm.num_items,) * 2),
             jnp.asarray(True), jax.random.key(5))
    step = jax.jit(jm._step_full)
    tm.epoch_item = tm.epoch_weights = None
    for i in range(2):
        masks = _jax_masks(carry[4], tm.config, tm.num_users + tm.num_items)
        batch = _batch(rng, jm)
        carry, ref = step(carry, _jax_batch(batch))
        got = tm.train_step((*(torch.from_numpy(x) for x in batch), masks))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
        ref_params = lattice_params_from_jax(jax.tree_util.tree_map(
            np.asarray, carry[0]))
        for name, value in tm.named_parameters():
            np.testing.assert_allclose(value.detach().numpy(),
                                       ref_params[name].numpy(), **TOL,
                                       err_msg=f"step {i}: {name}")
        assert not tm.epoch_weights.requires_grad
    # the graph the later steps use: the first step's, detached, as JAX's
    dense = np.zeros((tm.num_items,) * 2)
    g = tm.epoch_item.graph
    np.add.at(dense, (g.dst.numpy(), g.src.numpy()),
              tm.epoch_weights.numpy())
    np.testing.assert_allclose(dense, np.asarray(carry[2]), **TOL)
    tm.epoch_item = tm.epoch_weights = None


def test_draws_and_epoch_state(build, monkeypatch):
    """ngcf's masks are one (U + N, width) mask a layer at 1 - rate, none
    for the other models; an epoch selects its graph once, builds the
    weights with gradient once, and leaves no state behind."""
    jm, tm = build(cf_model="ngcf")
    gen = torch.Generator().manual_seed(6)
    masks = lattice_draws(gen, tm.config, 130)
    assert [tuple(m.shape) for m in masks] == [(130, DIM)] * 2
    assert lattice_draws(gen, LATTICEConfig(cf_model="ngcf",
                                            mess_dropout=[0.0, 0.5]),
                         130)[0] is None
    assert lattice_draws(gen, LATTICEConfig(), 130) is None
    calls = {"select": 0, "weights": 0}
    real_graph, real_loss = tm.item_graph, tm._loss

    def item_graph():
        calls["select"] += 1
        return real_graph()

    def loss(*args):
        calls["weights"] += args[-1] is None
        return real_loss(*args)
    monkeypatch.setattr(tm, "item_graph", item_graph)
    monkeypatch.setattr(tm, "_loss", loss)
    assert np.isfinite(tm._train_epoch(0))
    assert calls == {"select": 1, "weights": 1}
    assert tm.epoch_item is None and tm.epoch_weights is None


def test_predict_and_evaluate_rebuild_the_graph(build):
    """evaluate() selects the graph from the current parameters (JAX
    rebuilds it in evaluate): after new weights both agree again; the
    fused and chunked routes equal the full one."""
    jm, tm = build()
    for seed in (7, 8):
        _set_weights(jm, tm, np.random.default_rng(seed), 0.5)
        users = np.arange(jm.num_users)
        ref = np.asarray(jm.predict(users))
        np.testing.assert_allclose(tm.predict(users).numpy(), ref,
                                   rtol=1e-5, atol=1e-6 * np.abs(ref).max())
        ref, got = jm.evaluate(), tm.evaluate()
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


def test_config_registry_converter_and_fit(build, tmp_path, monkeypatch):
    jm, tm = build(cf_model="ngcf")
    reg = ModelRegistry()
    reg.load_skrx_model("LATTICE")
    cls, cfg_cls = reg.get_model("LATTICE")
    assert cls is LATTICE and cfg_cls is LATTICEConfig
    defaults, ref = LATTICEConfig(), JaxLATTICEConfig()
    for field in defaults.to_dict():
        assert getattr(defaults, field) == getattr(ref, field), field
    assert LATTICEConfig.param_space() == JaxLATTICEConfig.param_space()
    for bad in (dict(lr=1), dict(cf_model="gcn"), dict(graph_impl="dense")):
        with pytest.raises(ValueError):
            LATTICEConfig(**bad)
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    out = lattice_params_from_jax(params)
    assert set(out) == {n for n, _ in tm.named_parameters()}
    assert {"gc.0.w", "bi.1.b"} <= set(out)
    params["bi"] = params["bi"][:1]
    with pytest.raises(ValueError):
        lattice_params_from_jax(params)
    monkeypatch.chdir(tmp_path)
    if not torch.cuda.is_available():      # the default device is CUDA
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(RunConfig(data_dir=tm.dataset.data_dir), CFG)
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
    for key, value in m.named_parameters():
        assert torch.equal(state[key], value.detach()), key
