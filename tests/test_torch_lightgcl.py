"""LightGCL in the port against the JAX package's, on the same data and
weights. The SVD factors come from scipy ``svds`` on both sides, whose
start vector differs, so the factors are compared through the products
``u_mul_s @ vt`` and ``v_mul_s @ ut`` (free of sign); the forward, the
train step, predict and evaluate() run with JAX's factors copied in.
Tolerances rtol 1e-5 / atol 1e-6 (metrics within 1e-6). JAX runs
``graph_impl="segment"``."""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import scipy.sparse as sp
import torch

from skrx import RunConfig as JaxRunConfig
from skrx.io import synthetic as jax_synthetic
from skrx.models.LightGCL import LightGCL as JaxLightGCL
from skrx.models.LightGCL import LightGCLConfig as JaxLightGCLConfig
from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.convert import lightgcl_params_from_jax
from skrx_torch.models.LightGCL import (FACTORS, LightGCL, LightGCLConfig,
                                        lightgcl_dropout_masks,
                                        lightgcl_forward)
from skrx_torch.models.pipeline import epoch_generator
from skrx_torch.ops.graph import propagate

DIM = 8
CFG = dict(d=DIM, gnn_layer=2, lr=0.01, batch_size=32, svd_q=4,
           lambda2=1e-4)
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """JAX models at lambda1 0.2 and 0, and the port's (lambda1 0.2)."""
    root = tmp_path_factory.mktemp("torch_lightgcl")
    data = jax_synthetic.make_dataset_dir(str(root), num_users=60,
                                          num_items=90, num_ratings=1400,
                                          seed=5)
    cwd = os.getcwd()
    os.chdir(root)                         # the models write log/ here
    try:
        run = dict(data_dir=data, seed=1, metric=("NDCG", "Recall"),
                   top_k=(5, 10), test_batch_size=16)
        jms = {lam: JaxLightGCL(JaxRunConfig(recommender="LightGCL", **run),
                                dict(CFG, lambda1=lam, graph_impl="segment"))
               for lam in (0.2, 0.0)}
        tm = LightGCL(RunConfig(**run), dict(CFG, lambda1=0.2), device="cpu")
    finally:
        os.chdir(cwd)
    return jms, tm


def _factors(jm):
    return {k: np.asarray(getattr(jm, f"_{k}")) for k in FACTORS}


def _set_weights(jm, tm, rng, scale=0.3):
    params = {"E_u_0": rng.standard_normal((jm.num_users, DIM)) * scale,
              "E_i_0": rng.standard_normal((jm.num_items, DIM)) * scale}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    jm.params = {k: jnp.asarray(v) for k, v in params.items()}
    jm._final = None
    tm.load_jax_params(params, _factors(jm))
    return params


def test_svd_products_and_operator_match_jax(models):
    """u_mul_s @ vt and v_mul_s @ ut of the port's own svds equal JAX's
    (the rank-q approximation of R, whatever the signs); R and Rᵀ equal
    JAX's normalised edge list."""
    jms, tm = models
    jm = jms[0.2]
    ops = tm.ops
    for a, b, ja, jb in ((ops.u_mul_s, ops.vt, jm._u_mul_s, jm._vt),
                         (ops.v_mul_s, ops.ut, jm._v_mul_s, jm._ut)):
        np.testing.assert_allclose((a @ b).numpy(), np.asarray(ja @ jb),
                                   **TOL)
    r = sp.coo_matrix((np.asarray(jm._e_w), (np.asarray(jm._e_row),
                                             np.asarray(jm._e_col))),
                      shape=(jm.num_users, jm.num_items)).toarray()
    np.testing.assert_allclose(
        propagate(ops.r, torch.eye(jm.num_items)).numpy(), r, **TOL)
    np.testing.assert_allclose(
        propagate(ops.rt, torch.eye(jm.num_users)).numpy(), r.T, **TOL)


def test_layer_sums_match_jax(models):
    """E_u, E_i against JAX's embeddings; G_u, G_i against the SVD view of
    JAX's own R and factors in float64."""
    jms, tm = models
    jm = jms[0.2]
    params = _set_weights(jm, tm, np.random.default_rng(0))
    E_u, E_i, G_u, G_i = lightgcl_forward(
        tm.ops, *(torch.from_numpy(params[k]) for k in ("E_u_0", "E_i_0")),
        2)
    ref_u, ref_i = jm._embeddings_fn(jm.params)
    np.testing.assert_allclose(E_u.numpy(), np.asarray(ref_u), **TOL)
    np.testing.assert_allclose(E_i.numpy(), np.asarray(ref_i), **TOL)
    f = {k: v.astype(np.float64) for k, v in _factors(jm).items()}
    r = sp.csr_matrix((np.asarray(jm._e_w, np.float64),
                       (np.asarray(jm._e_row), np.asarray(jm._e_col))),
                      shape=(jm.num_users, jm.num_items))
    e_u, e_i = (params[k].astype(np.float64) for k in ("E_u_0", "E_i_0"))
    g_u, g_i = e_u.copy(), e_i.copy()
    for _ in range(2):
        g_u += f["u_mul_s"] @ (f["vt"] @ e_i)
        g_i += f["v_mul_s"] @ (f["ut"] @ e_u)
        e_u, e_i = r @ e_i, r.T @ e_u
    np.testing.assert_allclose(G_u.numpy(), g_u, **TOL)
    np.testing.assert_allclose(G_i.numpy(), g_i, **TOL)


@pytest.mark.parametrize("lambda1", [0.2, 0.0])
def test_train_step_matches_jax(models, lambda1):
    """Same params, factors and Adam state in both, then three fixed
    batches: each step's loss and the parameters after it agree."""
    from jax.flatten_util import ravel_pytree
    jms, tm = models
    jm = jms[lambda1]
    rng = np.random.default_rng(3)
    params = _set_weights(jm, tm, rng)
    flat, unravel = ravel_pytree(jm.params)
    mu = rng.standard_normal(flat.shape[0]).astype(np.float32) * 0.05
    nu = rng.uniform(1e-3, 1e-2, flat.shape[0]).astype(np.float32)
    adam, *rest = jm.optimizer.init(jm.params)
    opt = (adam._replace(count=jnp.asarray(2, jnp.int32), mu=unravel(mu),
                         nu=unravel(nu)), *rest)
    tm.load_jax_opt_state(2, mu, nu)
    carry = (jm.params, opt, jax.random.key(0))
    step = jax.jit(jm._step_with_key)
    u, n, b = jm.num_users, jm.num_items, 32
    tm.config.lambda1 = lambda1
    try:
        for _ in range(3):
            batch = (rng.integers(0, u, b), rng.integers(0, n, b),
                     rng.integers(0, n, (b, 1)),
                     (rng.random(b) < 0.9).astype(np.float32))
            carry, ref_loss = step(carry, tuple(
                jnp.asarray(x.astype(np.int32) if x.dtype != np.float32
                            else x) for x in batch))
            loss = tm.train_step(tuple(torch.from_numpy(x) for x in batch))
            np.testing.assert_allclose(float(loss), float(ref_loss),
                                       rtol=1e-5)
            for key in params:
                np.testing.assert_allclose(getattr(tm, key).detach().numpy(),
                                           np.asarray(carry[0][key]), **TOL)
    finally:
        tm.config.lambda1 = 0.2


def test_dropout_masks_contract(models, monkeypatch):
    """Two independent Bernoulli(1 - p) masks per layer, scaled by
    1 / (1 - p); a training step draws them from stream 1 of (seed + 1,
    epoch), the pipeline from stream 0."""
    _, tm = models
    p, e = 0.25, 200_000
    masks = lightgcl_dropout_masks(torch.Generator().manual_seed(0), e, 3, p)
    assert len(masks) == 3 and all(len(pair) == 2 for pair in masks)
    flat = [m for pair in masks for m in pair]
    for m in flat:
        assert m.shape == (e,) and m.dtype == torch.float32
        assert torch.equal(torch.unique(m),
                           torch.tensor([0.0, 1.0]) / (1 - p))
        assert abs(float((m != 0).double().mean()) - (1 - p)) < 0.005
    keeps = torch.stack([(m != 0).double() for m in flat])
    corr = torch.corrcoef(keeps)
    off = corr[~torch.eye(len(flat), dtype=torch.bool)]
    assert float(off.abs().max()) < 0.01              # independent draws
    assert lightgcl_dropout_masks(torch.Generator(), e, 3, 0.0) is None
    drawn = []
    real = tm.step_masks

    def spy():
        drawn.append(real())
        return drawn[-1]
    monkeypatch.setattr(tm, "step_masks", spy)
    monkeypatch.setattr(tm.config, "dropout", p)
    assert np.isfinite(tm._train_epoch(0))
    assert len(drawn) == tm.pipeline.num_batches
    want = lightgcl_dropout_masks(
        epoch_generator(2, 0, torch.device("cpu"), stream=1),
        tm.ops.r.num_edges, 2, p)
    for got_pair, want_pair in zip(drawn[0], want):
        for g, w in zip(got_pair, want_pair):
            assert torch.equal(g, w)
    with pytest.raises(RuntimeError):
        tm.step_masks()                            # outside an epoch


def test_predict_and_evaluate_match_jax(models):
    jms, tm = models
    jm = jms[0.2]
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


def test_config_registry_converter_and_fit(models, tmp_path, monkeypatch):
    _, tm = models
    reg = ModelRegistry()
    reg.load_skrx_model("LightGCL")
    cls, cfg_cls = reg.get_model("LightGCL")
    assert cls is LightGCL and cfg_cls is LightGCLConfig
    defaults, ref = LightGCLConfig(), JaxLightGCLConfig()
    for field in defaults.to_dict():
        assert getattr(defaults, field) == getattr(ref, field), field
    for bad in (dict(d=0), dict(temp=0.0), dict(svd_q=0),
                dict(dropout=-0.1), dict(lambda1=1), dict(graph_impl="x")):
        with pytest.raises(ValueError):
            LightGCLConfig(**bad)
    tables = {"E_u_0": np.zeros((3, 2)), "E_i_0": np.zeros((5, 2))}
    assert set(lightgcl_params_from_jax(tables)) == set(tables)
    with pytest.raises(ValueError):
        lightgcl_params_from_jax(dict(tables, E_i_0=np.zeros((5, 3))))
    with pytest.raises(ValueError):
        tm.load_jax_params({k: np.asarray(getattr(tm, k).detach())
                            for k in tables},
                           {k: np.zeros((1, 1)) for k in FACTORS})
    monkeypatch.chdir(tmp_path)
    if not torch.cuda.is_available():      # the default device is CUDA
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(RunConfig(data_dir=tm.dataset.data_dir), dict(CFG))
    m = cls(RunConfig(data_dir=tm.dataset.data_dir, seed=1, top_k=(10,)),
            dict(CFG, epochs=2, dropout=0.1), device="cpu")
    best = m.fit()
    losses = [h["loss"] for h in m.history]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses[1] < losses[0] and 0.0 <= best["NDCG@10"] <= 1.0
