"""CDAE in the port against the JAX package's, on the same data, weights,
Adam state and batch. One train step with JAX's own draws (the negatives
of ``skrx.ops.sampling.sample_negatives`` on the step's ``k_neg`` with 4
trials, the dropout mask of ``k_drop``), over both losses, both
activations and num_neg 0 and 2: loss and every parameter within rtol
1e-5 / atol 1e-6. The loss on a batch with repeated negatives and empty
slots against a plain reference; the Adam state from JAX's raveled order;
predict and the tower factors within rtol 1e-5, evaluate() within 1e-6 of
JAX's, the fused and chunked routes equal to the full one; config,
registry and fit() with checkpoint and resume."""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from skrx import RunConfig as JaxRunConfig
from skrx.io import synthetic as jax_synthetic
from skrx.models.CDAE import CDAE as JaxCDAE
from skrx.models.CDAE import CDAEConfig as JaxCDAEConfig
from skrx.ops.sampling import sample_negatives as jax_sample_negatives
from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.convert import cdae_params_from_jax
from skrx_torch.models.CDAE import CDAE, CDAEConfig, cdae_loss
from skrx_torch.models.pipeline import epoch_generator

DIM = 8
CFG = dict(hidden_dim=DIM, lr=0.01, reg=0.01, batch_size=16)
TOL = dict(rtol=1e-5, atol=1e-6)
RUN = dict(seed=1, metric=("NDCG", "Recall"), top_k=(5, 10),
           test_batch_size=16)
KEYS = ("de_bias", "de_emb", "en_emb", "en_offset", "user_emb")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def build(tmp_path_factory):
    """(jax model, port model) for config overrides, built once each."""
    root = tmp_path_factory.mktemp("torch_cdae")
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
                jm = JaxCDAE(JaxRunConfig(recommender="CDAE", data_dir=data,
                                          **RUN), cfg)
                tm = CDAE(RunConfig(data_dir=data, **RUN), cfg, device="cpu")
            finally:
                os.chdir(cwd)
            cache[key] = (jm, tm)
        return cache[key]
    return make


def _jax_params(rng, u, n, scale):
    def mat(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"en_emb": mat(n, DIM), "en_offset": mat(DIM),
            "de_emb": mat(n, DIM), "de_bias": mat(n), "user_emb": mat(u, DIM)}


def _set_weights(jm, tm, rng, scale=0.3):
    params = _jax_params(rng, jm.num_users, jm.num_items, scale)
    jm.params = jax.tree_util.tree_map(jnp.asarray, params)
    tm.load_jax_params(params)
    return params


def _jax_draws(jm, tm, key, users, dropout):
    """The draws of JAX's step with ``key``, rebuilt: k_neg, k_drop =
    split(key); the raw (B, max_k) negatives and the (B, N) keep mask."""
    k_neg, k_drop = jax.random.split(key)
    pos_table = jnp.asarray(
        jm.dataset.train_data.to_padded_positive_table().table)
    neg = jax_sample_negatives(k_neg, jnp.asarray(users, jnp.int32),
                               pos_table, jm.num_items, num_neg=tm.max_k,
                               num_trials=4)
    keep = None
    if dropout > 0:
        keep = torch.from_numpy(np.array(jax.random.bernoulli(
            k_drop, 1.0 - dropout, (len(users), jm.num_items))))
    return torch.from_numpy(np.array(neg)), keep


@pytest.mark.parametrize("num_neg", [0, 2])
@pytest.mark.parametrize("hidden_act", ["identity", "sigmoid"])
@pytest.mark.parametrize("loss_func", ["sigmoid_cross_entropy", "square"])
def test_train_step_matches_jax(build, loss_func, hidden_act, num_neg):
    """Same params and Adam state (count 3, JAX's moments converted), the
    same batch (two padded rows) and JAX's draws: the loss and every
    parameter after one step agree."""
    from jax.flatten_util import ravel_pytree
    jm, tm = build(loss_func=loss_func, hidden_act=hidden_act,
                   num_neg=num_neg)
    rng = np.random.default_rng(11)
    params = _set_weights(jm, tm, rng)
    flat, unravel = ravel_pytree(jm.params)
    mu = rng.standard_normal(flat.shape[0]).astype(np.float32) * 0.05
    nu = rng.uniform(1e-3, 1e-2, flat.shape[0]).astype(np.float32)
    adam, *rest = jm.opt_state
    opt = (adam._replace(count=jnp.asarray(3, jnp.int32), mu=unravel(mu),
                         nu=unravel(nu)), *rest)
    tm.load_jax_opt_state(3, mu, nu)
    users = rng.permutation(jm.num_users)[:16]
    w = np.ones(16, np.float32)
    w[-2:] = 0.0
    rows = jm.pipeline.rows_for(jnp.asarray(users, jnp.int32))
    key = jax.random.key(9)
    carry, ref_loss = jm._train_step(
        (jm.params, opt), (jnp.asarray(users, jnp.int32), rows,
                           jnp.asarray(w), key))
    neg, keep = _jax_draws(jm, tm, key, users, tm.config.dropout)
    t_users = torch.from_numpy(users.astype(np.int64))
    t_rows = tm.pipeline.rows_for(t_users)
    np.testing.assert_array_equal(t_rows.numpy(), np.asarray(rows))
    if num_neg:                 # the draws hold empty slots and repeats
        valid = (np.arange(tm.max_k)[None]
                 < tm.pos_lengths.numpy()[users][:, None] * num_neg)
        assert not valid.all()
        assert any(len(np.unique(r[v])) < v.sum()
                   for r, v in zip(neg.numpy(), valid))
    loss = tm.train_step((t_users, t_rows, torch.from_numpy(w),
                          (neg, keep)))
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    ref = cdae_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                      carry[0]))
    got = dict(tm.named_parameters())
    assert set(got) == set(ref) == set(KEYS)
    start = cdae_params_from_jax(params)
    for name, value in ref.items():
        np.testing.assert_allclose(got[name].detach().numpy(), value.numpy(),
                                   **TOL, err_msg=name)
        assert not np.allclose(value.numpy(), start[name].numpy()), name


def test_loss_on_repeated_negatives_and_empty_slots(build):
    """A negative drawn twice counts once, a slot past n_pos * num_neg is
    empty whatever it holds, a negative on a positive changes nothing, and
    a padded row adds nothing: against a plain loop over the rows."""
    _, tm = build(num_neg=2, hidden_act="sigmoid")
    p = {k: v.detach() for k, v in tm.named_parameters()}
    cfg, n = tm.config, tm.num_items
    users = torch.tensor([3, 5, 7])
    rows = tm.pipeline.rows_for(users)
    lengths = tm.pos_lengths[users].tolist()
    spare = int(torch.nonzero(rows[1] == 0)[-1])
    neg = torch.full((3, tm.max_k), 11, dtype=torch.int32)
    neg[0, :3] = torch.tensor([4, 4, 4])            # a repeat
    neg[1, 0] = int(torch.nonzero(rows[1])[0])      # on a positive
    neg[1, 2 * lengths[1]:] = spare                 # past the valid slots
    w = torch.tensor([1.0, 1.0, 0.0])
    keep = torch.rand((3, n), generator=torch.Generator().manual_seed(0)) \
        < 0.5
    got = cdae_loss(p, cfg, tm.pos_lengths, users, rows, w, neg, keep)
    loss, item_mask = 0.0, np.zeros(n, bool)
    x_all = []
    for b in range(3):
        cols = {int(c) for c in neg[b, :2 * lengths[b]]}
        x = rows[b].clone()
        x[sorted(cols)] = 1.0
        x_all.append(x.clone())
        x = torch.where(keep[b], x / (1 - cfg.dropout), 0.0)
        hid = torch.sigmoid(x @ p["en_emb"] + p["en_offset"]
                            + p["user_emb"][users[b]])
        logit = hid @ p["de_emb"].T + p["de_bias"]
        on = (x_all[b] > 0).numpy() & bool(w[b])
        y = rows[b]
        elem = (torch.clamp(logit, min=0) - logit * y
                + torch.log1p(torch.exp(-logit.abs())))
        loss += float(elem[torch.from_numpy(on)].sum())
        item_mask |= on
    assert x_all[1][spare] == 0
    im = torch.from_numpy(item_mask).float()
    reg = 0.5 * float((p["en_emb"] ** 2).sum(1) @ im
                      + (p["en_offset"] ** 2).sum()
                      + ((p["user_emb"][users] ** 2).sum(1) * w).sum()
                      + (p["de_emb"] ** 2).sum(1) @ im
                      + (p["de_bias"] ** 2) @ im)
    np.testing.assert_allclose(float(got), loss + cfg.reg * reg, rtol=1e-5)


def test_adam_state_from_jax_order(build):
    """JAX ravels the params by sorted key: de_bias, de_emb, en_emb,
    en_offset, user_emb; each moment lands on its parameter."""
    from jax.flatten_util import ravel_pytree
    jm, tm = build()
    tree = _jax_params(np.random.default_rng(2), jm.num_users, jm.num_items,
                       1.0)
    flat = np.asarray(ravel_pytree(jax.tree_util.tree_map(jnp.asarray,
                                                          tree))[0])
    np.testing.assert_array_equal(flat[:jm.num_items], tree["de_bias"])
    tm.load_jax_opt_state(5, flat, 2 * flat)
    for name, param in tm.named_parameters():
        state = tm.optimizer.state[param]
        assert float(state["step"]) == 5.0
        np.testing.assert_array_equal(state["exp_avg"].numpy(), tree[name])
        np.testing.assert_array_equal(state["exp_avg_sq"].numpy(),
                                      2 * tree[name])
    with pytest.raises(ValueError):
        tm.load_jax_opt_state(5, flat[:-1], flat[:-1])
    with pytest.raises(ValueError):
        cdae_params_from_jax(dict(tree, de_bias=np.zeros(3)))


@pytest.mark.parametrize("hidden_act", ["identity", "sigmoid"])
def test_predict_factors_and_evaluate_match_jax(build, hidden_act):
    jm, tm = build(hidden_act=hidden_act)
    _set_weights(jm, tm, np.random.default_rng(8), 1.0)
    users = np.arange(jm.num_users)
    np.testing.assert_allclose(tm.predict(users).numpy(),
                               np.asarray(jm.predict(users)), rtol=1e-5,
                               atol=1e-5)
    batch = torch.arange(20)                # a batch known by the tensor
    uv = tm._cached_user_vectors(batch)
    assert tm._cached_user_vectors(batch) is uv
    assert tm._cached_user_vectors(users[:20]) is not uv
    batch[0] = 21                           # changed in place: a miss
    assert not torch.equal(tm._cached_user_vectors(batch)[0], uv[0])
    uv = tm._cached_user_vectors(users[:20])
    assert tm._cached_user_vectors(users[:20].copy()) is uv
    ref = jm._topk_factors(jm._user_vectors(users[:20]))
    for got, want in zip(tm._topk_factors(uv), ref):
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


def test_config_registry_and_fit(build, tmp_path, monkeypatch):
    """Config and registry; fit() draws each step's negatives and mask from
    stream 1 of (seed + 1, epoch); checkpoint and resume."""
    _, tm = build()
    reg = ModelRegistry()
    reg.load_skrx_model("CDAE")
    cls, cfg_cls = reg.get_model("CDAE")
    assert cls is CDAE and cfg_cls is CDAEConfig
    defaults, ref = CDAEConfig(), JaxCDAEConfig()
    for field in defaults.to_dict():
        assert getattr(defaults, field) == getattr(ref, field), field
    for bad in (dict(dropout=1.0), dict(num_neg=-1), dict(hidden_act="relu"),
                dict(loss_func="hinge"), dict(hidden_dim=0), dict(lr=1)):
        with pytest.raises(ValueError):
            CDAEConfig(**bad)
    monkeypatch.chdir(tmp_path)
    if not torch.cuda.is_available():      # the default device is CUDA
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(RunConfig(data_dir=tm.dataset.data_dir), dict(CFG))
    run = dict(data_dir=tm.dataset.data_dir, seed=1, top_k=(10,),
               checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1)
    m = cls(RunConfig(**run), dict(CFG, epochs=2), device="cpu")
    drawn = []
    real = m.step_draws
    m.step_draws = lambda users: drawn.append(real(users)) or drawn[-1]
    m.fit()
    losses = [h["loss"] for h in m.history]
    assert len(losses) == 2 and all(np.isfinite(losses))
    steps = m.pipeline.num_batches
    assert len(drawn) == 2 * steps
    users = next(m.pipeline.batches(epoch_generator(2, 1,
                                                    torch.device("cpu"))))[0]
    gen = epoch_generator(2, 1, torch.device("cpu"), stream=1)
    want = (torch.randint(0, m.num_items, (16, 4 * m.max_k), generator=gen,
                          dtype=torch.int32),
            torch.rand((16, m.num_items), generator=gen) < 0.5)
    assert torch.equal(drawn[steps][1], want[1])
    # each slot: the first of its 4 candidates off the user's positives,
    # else the last
    cand = want[0].reshape(16, m.max_k, 4)
    rows = m.pipeline.pos_table[users]
    off = ~torch.stack([torch.isin(cand[b], rows[b]) for b in range(16)])
    pick = torch.where(off.any(-1), off.int().argmax(-1), 3)
    assert torch.equal(drawn[steps][0],
                       cand.gather(-1, pick[..., None])[..., 0])
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
    for name, value in m.named_parameters():
        assert torch.equal(state[name], value.detach()), name
