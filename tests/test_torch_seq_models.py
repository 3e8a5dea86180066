"""FPMC and TransRec in the port against the JAX package's, on the same
data, weights, optimizer state and batches. Two train steps on fixed
batches (repeated rows, padded rows of weight 0) under dense Adam (JAX's
flat Adam state converted) and under lazy Adam (JAX's per-table lazy state,
TransRec's dense ``trans`` state too): the loss and every parameter within
rtol 1e-5 / atol 1e-6. Each user's last item; predict within rtol 1e-5,
evaluate() within 1e-6 of JAX's; FPMC's fused and both models' chunked
routes equal to the full one; config checks, the registry, the converters
and fit() with checkpoint and resume."""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from skrx import RunConfig as JaxRunConfig
from skrx.io import synthetic as jax_synthetic
from skrx.models.FPMC import FPMC as JaxFPMC
from skrx.models.FPMC import FPMCConfig as JaxFPMCConfig
from skrx.models.TransRec import TransRec as JaxTransRec
from skrx.models.TransRec import TransRecConfig as JaxTransRecConfig
from skrx.ops import optim as joptim
from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.convert import fpmc_params_from_jax, transrec_params_from_jax
from skrx_torch.models.FPMC import FPMC, FPMCConfig
from skrx_torch.models.TransRec import TransRec, TransRecConfig

DIM = 8
TOL = dict(rtol=1e-5, atol=1e-6)
RUN = dict(seed=1, metric=("NDCG", "Recall"), top_k=(5, 10),
           test_batch_size=16)
MODELS = {"FPMC": (JaxFPMC, FPMC, JaxFPMCConfig, FPMCConfig,
                   fpmc_params_from_jax),
          "TransRec": (JaxTransRec, TransRec, JaxTransRecConfig,
                       TransRecConfig, transrec_params_from_jax)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def build(tmp_path_factory):
    """(jax model, port model) of a name and config overrides."""
    root = tmp_path_factory.mktemp("torch_seq_models")
    data = jax_synthetic.make_dataset_dir(str(root), num_users=50,
                                          num_items=80, num_ratings=1300,
                                          seed=8)
    cache = {}

    def make(name, **over):
        key = (name,) + tuple(sorted(over.items()))
        if key not in cache:
            jcls, tcls = MODELS[name][:2]
            cfg = dict(embed_size=DIM, lr=0.01, reg=0.02, batch_size=16,
                       **over)
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


def _params(name, rng, u, n):
    def mat(*shape):
        return (rng.standard_normal(shape) * 0.3).astype(np.float32)
    if name == "FPMC":
        return {"UI": mat(u, DIM), "IU": mat(n, DIM), "IL": mat(n, DIM),
                "LI": mat(n, DIM)}
    return {"user_emb": mat(u, DIM), "item_emb": mat(n, DIM),
            "trans": mat(1, DIM), "item_bias": mat(n)}


def _set_weights(name, jm, tm, rng):
    params = _params(name, rng, jm.num_users, jm.num_items)
    jm.params = {k: jnp.asarray(v) for k, v in params.items()}
    tm.load_jax_params(params)
    return params


def _batches(rng, u, n, b=16, steps=2):
    """Fixed batches (users, pos, neg (B, 1), w, prev (B, 1)) with repeated
    rows and two padded rows of weight 0."""
    out = []
    for _ in range(steps):
        users = rng.integers(0, u, b)
        pos, neg, prev = (rng.integers(0, n, s) for s in (b, (b, 1), (b, 1)))
        users[:4], pos[:4], prev[:4, 0] = users[4:8], pos[4:8], pos[8:12]
        w = np.ones(b, np.float32)
        w[-2:] = 0.0
        out.append((users, pos, neg, w, prev))
    return out


def _jax_batch(batch):
    return tuple(jnp.asarray(x.astype(np.int32) if x.dtype != np.float32
                             else x) for x in batch)


def _port_batch(batch):
    return tuple(torch.from_numpy(x.astype(np.int64) if x.dtype != np.float32
                                  else x) for x in batch)


def _lazy_state(rng, shape):
    return joptim.LazyAdamState(
        jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 0.05),
        jnp.asarray(rng.uniform(1e-3, 1e-2, shape).astype(np.float32)),
        jnp.asarray(rng.integers(0, 5, shape[0]).astype(np.int32)))


@pytest.mark.parametrize("optimizer", ["adam", "lazy_adam"])
@pytest.mark.parametrize("name", ["FPMC", "TransRec"])
def test_train_steps_match_jax(build, name, optimizer):
    from jax.flatten_util import ravel_pytree
    jm, tm = build(name, optimizer=optimizer)
    convert = MODELS[name][4]
    rng = np.random.default_rng(11)
    params = _set_weights(name, jm, tm, rng)
    if optimizer == "adam":
        flat, unravel = ravel_pytree(jm.params)
        mu = rng.standard_normal(flat.shape[0]).astype(np.float32) * 0.05
        nu = rng.uniform(1e-3, 1e-2, flat.shape[0]).astype(np.float32)
        adam, *rest = jm.optimizer.init(flat)
        carry = (flat, (adam._replace(count=jnp.asarray(3, jnp.int32),
                                      mu=jnp.asarray(mu),
                                      nu=jnp.asarray(nu)), *rest))
        tm.load_jax_opt_state(3, mu, nu)
    else:
        lazy, dense = jm.opt_state
        lazy = {k: _lazy_state(rng, params[k].shape) for k in lazy}
        if name == "TransRec":
            adam, *rest = dense
            count, mu, nu = 2, *(rng.uniform(1e-3, 1e-2, (2, 1, DIM))
                                 .astype(np.float32))
            dense = (adam._replace(count=jnp.asarray(count, jnp.int32),
                                   mu={"trans": jnp.asarray(mu)},
                                   nu={"trans": jnp.asarray(nu)}), *rest)
            tm.load_jax_opt_state(lazy, (count, mu, nu))
        else:
            tm.load_jax_opt_state(lazy)
        carry = (jm.params, (lazy, dense))
    np.testing.assert_array_equal(tm.last_items.numpy(),
                                  np.asarray(jm._last_items))
    step = jax.jit(jm._train_step)
    for batch in _batches(rng, jm.num_users, jm.num_items):
        carry, ref_loss = step(carry, _jax_batch(batch))
        loss = tm.train_step(_port_batch(batch))
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    ref = unravel(carry[0]) if optimizer == "adam" else carry[0]
    ref = convert(jax.tree_util.tree_map(np.asarray, ref))
    start = convert(params)
    for key, value in ref.items():
        got = getattr(tm, key).detach().numpy()
        np.testing.assert_allclose(got, value.numpy(), **TOL, err_msg=key)
        assert not np.array_equal(value.numpy(), start[key].numpy()), key
    if optimizer == "lazy_adam":
        for key, state in carry[1][0].items():
            live = tm.optimizer.states[key]
            for field in ("m", "v", "counts"):
                np.testing.assert_allclose(
                    getattr(live, field).numpy(),
                    np.asarray(getattr(state, field)), **TOL)
            assert getattr(tm, key).grad is None     # no (N, d) gradient


@pytest.mark.parametrize("name", ["FPMC", "TransRec"])
def test_predict_and_evaluate_match_jax(build, name):
    jm, tm = build(name)
    _set_weights(name, jm, tm, np.random.default_rng(5))
    if name == "FPMC":
        jm._concat_cache = None
    users = np.arange(jm.num_users)
    np.testing.assert_allclose(tm.predict(users).numpy(),
                               np.asarray(jm.predict(users)), **TOL)
    if name == "TransRec":           # the factors of the expanded score
        uv = tm._cached_user_vectors(users[:9])
        np.testing.assert_allclose(
            tm._topk_score_fn(*tm._topk_factors(uv)).detach().numpy(),
            tm.predict(users[:9]).numpy(), **TOL)
        np.testing.assert_allclose(uv.numpy(),
                                   np.asarray(jm._user_vectors(users[:9])),
                                   **TOL)
    else:
        got, ref = tm._chunk_embeddings(), jm._chunk_embeddings()
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        assert tm._chunk_embeddings()[1] is got[1]      # kept until a step
    ref, got = jm.evaluate(), tm.evaluate()
    assert list(got.metrics()) == list(ref.metrics())
    np.testing.assert_allclose(list(got.values()), list(ref.values()),
                               rtol=0, atol=1e-6)
    ev = tm.evaluator
    for mode in (("fused", "chunked") if name == "FPMC" else ("chunked",)):
        ev.eval_mode, ev.chunk_size = mode, 32
        try:
            np.testing.assert_allclose(list(tm.evaluate().values()),
                                       list(got.values()), rtol=0, atol=1e-6)
        finally:
            ev.eval_mode = "full"
    if name == "TransRec":
        ev.eval_mode = "fused"
        try:
            with pytest.raises(TypeError, match="fused"):
                tm.evaluate()
        finally:
            ev.eval_mode = "full"


@pytest.mark.parametrize("name", ["FPMC", "TransRec"])
def test_config_registry_converters_and_fit(build, name, tmp_path,
                                            monkeypatch):
    """Config and registry; the converters refuse bad keys and shapes;
    fit() under both optimizers, checkpoint and resume."""
    _, tm = build(name)
    _, cls, jcfg_cls, cfg_cls, convert = MODELS[name]
    reg = ModelRegistry()
    reg.load_skrx_model(name)
    assert reg.get_model(name) == (cls, cfg_cls)
    defaults, ref = cfg_cls(), jcfg_cls()
    for field in defaults.to_dict():
        assert getattr(defaults, field) == getattr(ref, field), field
    for bad in (dict(optimizer="sgd"), dict(embed_size=0), dict(lr=1),
                dict(batch_size=0)):
        with pytest.raises(ValueError):
            cfg_cls(**bad)
    params = _params(name, np.random.default_rng(0), 4, 6)
    with pytest.raises(ValueError):
        convert({k: v for k, v in list(params.items())[:-1]})
    key = list(params)[1]
    with pytest.raises(ValueError):
        convert(dict(params, **{key: params[key][:, :3]}))
    monkeypatch.chdir(tmp_path)
    for optimizer in ("adam", "lazy_adam"):
        run = dict(data_dir=tm.dataset.data_dir, seed=1, top_k=(10,),
                   checkpoint_dir=str(tmp_path / optimizer),
                   checkpoint_every=1)
        cfg = dict(embed_size=DIM, batch_size=64, optimizer=optimizer)
        m = cls(RunConfig(**run), dict(cfg, epochs=2), device="cpu")
        m.fit()
        losses = [h["loss"] for h in m.history]
        assert len(losses) == 2 and all(np.isfinite(losses))
        resumed = cls(RunConfig(**run, resume=True), dict(cfg, epochs=3),
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
