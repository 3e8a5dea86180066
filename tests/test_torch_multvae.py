"""MultVAE in the port against the JAX package's, on the same data,
weights, Adam state, batch and step count. One train step with JAX's own
draws (the dropout mask of ``k_drop`` and ``eps`` of ``k_eps``, rebuilt
from the step's key) at anneal counts 0, below and past the cap, with
``q_dims`` given and with two decoder layers: loss and every parameter
within rtol 1e-5 / atol 1e-6; under ``compute_dtype="bfloat16"`` the
loss and each parameter's gradient within the looser bounds that test
states. The step count across a
checkpoint and resume; the nested Adam state from JAX's raveled order;
predict and the tower factors within rtol 1e-5, evaluate() within 1e-6
of JAX's, the fused and chunked routes equal to the full one."""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from skrx import RunConfig as JaxRunConfig
from skrx.io import synthetic as jax_synthetic
from skrx.models.MultVAE import MultVAE as JaxMultVAE
from skrx.models.MultVAE import MultVAEConfig as JaxMultVAEConfig
from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.convert import multvae_params_from_jax
from skrx_torch.models.MultVAE import MultVAE, MultVAEConfig

CFG = dict(p_dims=[8], lr=0.01, reg=0.01, batch_size=16)
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
    root = tmp_path_factory.mktemp("torch_multvae")
    data = jax_synthetic.make_dataset_dir(str(root), num_users=60,
                                          num_items=90, num_ratings=1400,
                                          seed=6)
    cache = {}

    def make(**over):
        key = repr(sorted(over.items()))
        if key not in cache:
            cwd = os.getcwd()
            os.chdir(root)                 # the models write log/ here
            try:
                cfg = dict(CFG, **over)
                jm = JaxMultVAE(JaxRunConfig(recommender="MultVAE",
                                             data_dir=data, **RUN), dict(cfg))
                tm = MultVAE(RunConfig(data_dir=data, **RUN), dict(cfg),
                             device="cpu")
            finally:
                os.chdir(cwd)
            cache[key] = (jm, tm)
        return cache[key]
    return make


def _jax_params(rng, q_dims, p_dims, scale):
    def mlp(dims):
        return [{"w": (rng.standard_normal((a, b)) * scale)
                 .astype(np.float32),
                 "b": (rng.standard_normal(b) * scale).astype(np.float32)}
                for a, b in zip(dims[:-1], dims[1:])]
    return {"q": mlp(q_dims[:-1] + [2 * q_dims[-1]]), "p": mlp(p_dims)}


def _set_weights(jm, tm, rng, scale=0.3):
    params = _jax_params(rng, jm.q_dims, jm.p_dims, scale)
    jm.params = jax.tree_util.tree_map(jnp.asarray, params)
    tm.load_jax_params(params)
    return params


def _batches(jm, tm, rng, count):
    """One batch of 16 users (two padded rows) and JAX's draws of key 9:
    (JAX's batch, the port's with the draws); the port's step count set
    to ``count``."""
    users = rng.permutation(jm.num_users)[:16]
    w = np.ones(16, np.float32)
    w[-2:] = 0.0
    rows = jm.pipeline.rows_for(jnp.asarray(users, jnp.int32))
    key = jax.random.key(9)
    k_drop, k_eps = jax.random.split(key)
    keep = jax.random.bernoulli(k_drop, tm.config.keep_prob,
                                (16, jm.num_items))
    eps = jax.random.normal(k_eps, (16, tm.q_dims[-1]))
    t_users = torch.from_numpy(users.astype(np.int64))
    tm.update_count = torch.tensor(count, dtype=torch.float32)
    return ((jnp.asarray(users, jnp.int32), rows, jnp.asarray(w), key),
            (t_users, tm.pipeline.rows_for(t_users), torch.from_numpy(w),
             (torch.from_numpy(np.array(keep)),
              torch.from_numpy(np.array(eps)))))


def _step(jm, tm, count, seed=11):
    """One step of each model from the same params, Adam state (count 3),
    step count and batch, the port given JAX's draws: (JAX's carry and
    loss, the port's loss, the starting params)."""
    from jax.flatten_util import ravel_pytree
    rng = np.random.default_rng(seed)
    params = _set_weights(jm, tm, rng)
    flat, unravel = ravel_pytree(jm.params)
    mu = rng.standard_normal(flat.shape[0]).astype(np.float32) * 0.05
    nu = rng.uniform(1e-3, 1e-2, flat.shape[0]).astype(np.float32)
    adam, *rest = jm.opt_state
    opt = (adam._replace(count=jnp.asarray(3, jnp.int32), mu=unravel(mu),
                         nu=unravel(nu)), *rest)
    tm.load_jax_opt_state(3, mu, nu)
    jax_batch, batch = _batches(jm, tm, rng, count)
    carry, ref_loss = jm._train_step(
        (jm.params, opt, jnp.asarray(count, jnp.float32)), jax_batch)
    loss = tm.train_step(batch)
    assert float(tm.update_count) == float(carry[2]) == count + 1
    return carry, ref_loss, loss, params


def _grads(jm, tm, count, seed=11):
    """The gradients of one batch's loss in each framework, from the same
    params, step count, batch and draws, by the port's parameter names:
    (JAX's, the port's). JAX's come from its own train step run with
    ``optax.identity()`` as the optimizer (the new params are the old plus
    the gradient)."""
    import optax
    rng = np.random.default_rng(seed)
    params = _set_weights(jm, tm, rng)
    jax_batch, batch = _batches(jm, tm, rng, count)
    adam = jm.optimizer
    jm.optimizer = optax.identity()
    try:
        carry, _ = jm._train_step(
            (jm.params, jm.optimizer.init(jm.params),
             jnp.asarray(count, jnp.float32)), jax_batch)
    finally:
        jm.optimizer = adam
    ref = multvae_params_from_jax(jax.tree_util.tree_map(
        lambda new, old: np.asarray(new) - old, carry[0], params))
    names, leaves = zip(*tm.named_parameters())
    got = dict(zip(names, torch.autograd.grad(tm._loss(*batch), leaves)))
    return ref, got


@pytest.mark.parametrize("over, count", [
    (dict(), 0.0),
    (dict(), 60_000.0),                     # anneal past the cap, 0.2
    (dict(anneal_steps=40), 7.0),           # below it
    (dict(q_dims=[16, 8]), 3.0),
    (dict(p_dims=[8, 16]), 3.0),
], ids=["count0", "capped", "below_cap", "q_dims", "two_p_layers"])
def test_train_step_matches_jax(build, over, count):
    jm, tm = build(**over)
    carry, ref_loss, loss, params = _step(jm, tm, count)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    ref = multvae_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                         carry[0]))
    got = dict(tm.named_parameters())
    assert set(got) == set(ref)
    start = multvae_params_from_jax(params)
    for name, value in ref.items():
        np.testing.assert_allclose(got[name].detach().numpy(), value.numpy(),
                                   **TOL, err_msg=name)
        assert not np.allclose(value.numpy(), start[name].numpy()), name


def test_bfloat16_step_and_factors_match_jax(build):
    """bf16 compute: each matmul and bias add rounds to bf16 (8 bits of
    mantissa, a relative step of 2^-8) in a different order in the two
    frameworks, so the loss agrees within rtol 1e-2 and each parameter's
    gradient within 2^-5 of its tensor's largest gradient, at anneal 0 and
    at the cap (sound runs differ by at most 0.0057 of it, in the biases;
    a zero, detached or wrong-signed backward is off by about the whole
    largest gradient). One step's parameters are not
    compared: at the test's Adam moments a step moves an element by about
    lr whatever its gradient. predict and the tower's user vectors within
    2^-6 of their largest magnitude (4 steps of bf16 rounding), the
    rounded item table and bias within rtol 1e-5."""
    jm, tm = build(compute_dtype="bfloat16")
    _, ref_loss, loss, _ = _step(jm, tm, 5.0)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-2)
    for count in (0.0, 60_000.0):          # anneal 0 and the cap
        ref, got = _grads(jm, tm, count)
        assert set(got) == set(ref)
        for name, want in ref.items():
            want = want.numpy()
            scale = np.abs(want).max()
            assert scale > 0, name
            np.testing.assert_allclose(got[name].numpy(), want, rtol=0,
                                       atol=2 ** -5 * scale, err_msg=name)
    _set_weights(jm, tm, np.random.default_rng(8), 1.0)
    users = np.arange(jm.num_users)
    want = np.asarray(jm.predict(users))
    np.testing.assert_allclose(tm.predict(users).numpy(), want, rtol=0,
                               atol=2 ** -6 * np.abs(want).max())
    uv = tm._cached_user_vectors(users[:20])
    ref = jm._topk_factors(jm._user_vectors(users[:20]))
    got = tm._topk_factors(uv)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=2 ** -6 * np.abs(np.asarray(ref[0])).max())
    for g, want in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(want),
                                   **TOL)


def test_adam_state_from_jax_nested_order(build):
    """JAX ravels {"p": [...], "q": [...]} by sorted key and list index,
    each layer's b before its w: p/0/b, p/0/w, p/1/b, ..., q/0/b, q/0/w;
    a w's moments land transposed on its nn.Linear weight."""
    from jax.flatten_util import ravel_pytree
    jm, tm = build(p_dims=[8, 16])
    tree = _jax_params(np.random.default_rng(2), jm.q_dims, jm.p_dims, 1.0)
    flat = np.asarray(ravel_pytree(jax.tree_util.tree_map(jnp.asarray,
                                                          tree))[0])
    np.testing.assert_array_equal(flat[:16], tree["p"][0]["b"])
    np.testing.assert_array_equal(flat[16:16 + 8 * 16],
                                  tree["p"][0]["w"].ravel())
    tm.load_jax_opt_state(5, flat, 2 * flat)
    want = multvae_params_from_jax(tree)
    assert set(want) == {n for n, _ in tm.named_parameters()}
    for name, param in tm.named_parameters():
        state = tm.optimizer.state[param]
        assert float(state["step"]) == 5.0
        np.testing.assert_array_equal(state["exp_avg"].numpy(),
                                      want[name].numpy())
        np.testing.assert_array_equal(state["exp_avg_sq"].numpy(),
                                      2 * want[name].numpy())
    with pytest.raises(ValueError):
        tm.load_jax_opt_state(5, flat[:-1], flat[:-1])
    bad = dict(tree, p=tree["p"][:1])       # decoder ends short of N
    with pytest.raises(ValueError):
        multvae_params_from_jax(bad)


@pytest.mark.parametrize("over", [dict(), dict(p_dims=[8, 16])],
                         ids=["one_p_layer", "two_p_layers"])
def test_predict_factors_and_evaluate_match_jax(build, over):
    jm, tm = build(**over)
    _set_weights(jm, tm, np.random.default_rng(8))
    users = np.arange(jm.num_users)
    np.testing.assert_allclose(tm.predict(users).numpy(),
                               np.asarray(jm.predict(users)), rtol=1e-5,
                               atol=1e-5)
    uv = tm._cached_user_vectors(users[:20])
    for got, want in zip(tm._topk_factors(uv),
                         jm._topk_factors(jm._user_vectors(users[:20]))):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)
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


def test_config_registry_and_step_count_across_resume(build, tmp_path,
                                                      monkeypatch):
    """Config and registry; fit() counts its steps, a checkpoint carries
    the count, and a resumed fit() anneals from it as an uninterrupted
    one."""
    _, tm = build()
    reg = ModelRegistry()
    reg.load_skrx_model("MultVAE")
    cls, cfg_cls = reg.get_model("MultVAE")
    assert cls is MultVAE and cfg_cls is MultVAEConfig
    defaults, ref = MultVAEConfig(), JaxMultVAEConfig()
    assert defaults.p_dims == [64]
    for field in defaults.to_dict():
        assert getattr(defaults, field) == getattr(ref, field), field
    for bad in (dict(p_dims=64), dict(q_dims=(8,)), dict(keep_prob=-0.1),
                dict(anneal_steps=-1), dict(compute_dtype="float16"),
                dict(lr=1)):
        with pytest.raises(ValueError):
            MultVAEConfig(**bad)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="Latent"):
        cls(RunConfig(data_dir=tm.dataset.data_dir), dict(CFG, q_dims=[16]),
            device="cpu")
    if not torch.cuda.is_available():      # the default device is CUDA
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(RunConfig(data_dir=tm.dataset.data_dir), dict(CFG))
    run = dict(data_dir=tm.dataset.data_dir, seed=1, top_k=(10,),
               checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1)
    cfg = dict(CFG, epochs=2, anneal_steps=10)
    m = cls(RunConfig(**run), cfg, device="cpu")
    anneals = []
    real = m.anneal
    m.anneal = lambda: anneals.append(float(real())) or real()
    m.fit()
    steps = m.pipeline.num_batches
    assert [h["epoch"] for h in m.history] == [0, 1]
    assert float(m.update_count) == 2 * steps
    assert anneals == [float(np.minimum(np.float32(0.2),
                                        np.float32(i) / np.float32(10)))
                       for i in range(2 * steps)]
    whole = cls(RunConfig(**dict(run, checkpoint_dir="")),
                dict(cfg, epochs=3), device="cpu")
    whole.fit()
    resumed = cls(RunConfig(**run, resume=True), dict(cfg, epochs=3),
                  device="cpu")
    assert float(resumed.update_count) == 0.0
    resumed.fit()
    assert [h["epoch"] for h in resumed.history] == [2]
    assert float(resumed.update_count) == float(whole.update_count) \
        == 3 * steps
    np.testing.assert_allclose(resumed.history[0]["loss"],
                               whole.history[2]["loss"], rtol=1e-6)
    for (name, value), other in zip(resumed.named_parameters(),
                                    whole.parameters()):
        assert torch.equal(value, other), name
