"""Row-wise lazy Adam and optax's Adagrad in the port
(``skrx_torch/ops/optim.py``) against the JAX package's ``skrx.ops.optim``
and ``optax.adagrad``, and BPRMF's lazy step against JAX's, on the same
numpy-seeded inputs. Tolerance: 1e-6 relative (and 1e-7 absolute where a
value may sit near zero); rows the step does not touch, their moments and
counts are compared bit for bit."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import optax
import torch

from skrx import RunConfig as JaxRunConfig
from skrx.io import synthetic as jax_synthetic
from skrx.models.BPRMF import BPRMF as JaxBPRMF
from skrx.ops import optim as joptim
from skrx_torch import RunConfig
from skrx_torch.convert import (adagrad_state_from_jax,
                                lazy_adam_state_from_jax)
from skrx_torch.models.BPRMF import BPRMF
from skrx_torch.models.common import make_optimizer
from skrx_torch.ops import optim as toptim

RTOL, ATOL = 1e-6, 1e-7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Steps of a few small ops: one intra-op thread keeps them fast when
    the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rows(rng, n, k, drop):
    """k row ids in [0, n) with repeats, two of them the drop id."""
    rows = rng.integers(0, n, k)
    rows[: k // 3] = rows[k // 3: 2 * (k // 3)]          # repeats
    rows[[1, k - 2]] = drop
    return rng.permutation(rows)


@pytest.mark.parametrize("shape", [(24, 5), (24,)])
def test_dedup_rows_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    k = 19
    rows = _rows(rng, shape[0], k, shape[0])
    grads = rng.standard_normal((k,) + shape[1:]).astype(np.float32)
    ref_u, ref_g = joptim.dedup_rows(jnp.asarray(rows.astype(np.int32)),
                                     jnp.asarray(grads), shape[0])
    got_u, got_g = toptim.dedup_rows(_t(rows), _t(grads), shape[0])
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(ref_u))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(ref_g), rtol=RTOL,
                               atol=ATOL)


def _state(rng, shape):
    m = rng.standard_normal(shape).astype(np.float32) * 0.1
    v = rng.uniform(1e-4, 1e-2, shape).astype(np.float32)
    counts = rng.integers(0, 9, shape[0]).astype(np.int32)
    return m, v, counts


@pytest.mark.parametrize("shape,wd", [((30, 6), 0.0), ((30, 6), 0.05),
                                      ((30,), 0.0), ((30,), 0.05)])
def test_lazy_adam_row_update_matches_jax(shape, wd):
    """Repeated rows, dropped ids (== N), a random prior state; untouched
    rows of the table, m, v and counts stay bit for bit."""
    rng = np.random.default_rng(7 + len(shape))
    n, k = shape[0], 23
    table = rng.standard_normal(shape).astype(np.float32)
    m, v, counts = _state(rng, shape)
    rows = _rows(rng, n, k, n)
    grads = rng.standard_normal((k,) + shape[1:]).astype(np.float32)
    ref_state, ref_table = joptim.lazy_adam_row_update(
        joptim.LazyAdamState(*map(jnp.asarray, (m, v, counts))),
        jnp.asarray(table), jnp.asarray(rows.astype(np.int32)),
        jnp.asarray(grads), 0.01, weight_decay=wd)
    state = toptim.LazyAdamState(**lazy_adam_state_from_jax(m, v, counts))
    t_table = _t(table)
    got_state, got_table = toptim.lazy_adam_row_update(
        state, t_table, _t(rows), _t(grads), 0.01, weight_decay=wd)
    assert got_table is t_table and got_state.m is state.m   # in place
    np.testing.assert_allclose(got_table.numpy(), np.asarray(ref_table),
                               rtol=RTOL, atol=ATOL)
    for got, ref in zip(got_state, ref_state):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)
    assert got_state.counts.dtype == torch.int32
    untouched = np.setdiff1d(np.arange(n), rows)
    assert len(untouched) > 0
    for got, before in ((got_table, table), (got_state.m, m),
                        (got_state.v, v), (got_state.counts, counts)):
        assert np.array_equal(got.numpy()[untouched], before[untouched])


def test_lazy_adam_of_only_dropped_rows_changes_nothing():
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    state = toptim.lazy_adam_init(_t(table))
    _, got = toptim.lazy_adam_row_update(state, _t(table), _t([4, 4]),
                                         _t(np.ones((2, 3), np.float32)), 0.1)
    assert np.array_equal(got.numpy(), table)
    assert not state.counts.any() and not state.m.any()


def test_make_lazy_train_step_matches_jax_on_mixed_params():
    """Two tables (one gathered twice) and a dense leaf, with weight decay:
    three steps against JAX's make_lazy_train_step."""
    rng = np.random.default_rng(3)
    n, d = 40, 4
    params = {"emb": rng.standard_normal((n, d)).astype(np.float32),
              "bias": rng.standard_normal(n).astype(np.float32),
              "w": rng.standard_normal((d, d)).astype(np.float32)}
    gathers = [("emb", lambda b: b[0]), ("emb", lambda b: b[1]),
               ("bias", lambda b: b[1])]

    def loss_fn(xp):
        def fn(gathered, dense, batch):
            a, c, bias = gathered
            return (xp.sum((a @ dense["w"]) * c) + xp.sum(bias ** 2)
                    + xp.sum(dense["w"] ** 2))
        return fn

    step, opt_state = joptim.make_lazy_train_step(
        0.01, gathers, loss_fn(jnp), {k: jnp.asarray(v) for k, v in
                                      params.items()}, weight_decay=0.01)
    carry = ({k: jnp.asarray(v) for k, v in params.items()}, opt_state)
    t_params = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    t_step, (lazy, dense_opt) = toptim.make_lazy_train_step(
        0.01, gathers, loss_fn(torch), t_params, weight_decay=0.01)
    for _ in range(3):
        batch = (rng.integers(0, n, 9), rng.integers(0, n, 9))
        batch[0][:3] = batch[1][:3]
        carry, ref_loss = jax.jit(step)(carry, tuple(
            jnp.asarray(b.astype(np.int32)) for b in batch))
        loss = t_step(tuple(_t(b) for b in batch))
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
        for key in params:
            np.testing.assert_allclose(t_params[key].detach().numpy(),
                                       np.asarray(carry[0][key]), rtol=1e-5,
                                       atol=1e-6)
        for key in ("emb", "bias"):
            np.testing.assert_array_equal(
                lazy.states[key].counts.numpy(),
                np.asarray(carry[1][0][key].counts))
    assert t_params["emb"].grad is None and t_params["bias"].grad is None
    with pytest.raises(TypeError, match="no dense step"):
        lazy.step()


def test_optax_adagrad_matches_optax():
    rng = np.random.default_rng(5)
    p0 = rng.standard_normal((6, 3)).astype(np.float32)
    grads = [rng.standard_normal((6, 3)).astype(np.float32) for _ in "abc"]
    grads[1][2] = 0.0
    opt = optax.adagrad(0.05)
    p, s = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(_t(p0))
    topt = toptim.OptaxAdagrad([tp], 0.05)
    for g in grads:
        upd, s = opt.update(jnp.asarray(g), s, p)
        p = optax.apply_updates(p, upd)
        tp.grad = _t(g)
        topt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(p), rtol=RTOL,
                               atol=ATOL)
    acc = adagrad_state_from_jax({"w": np.asarray(s[0].sum_of_squares)},
                                 {"w": (6, 3)})["w"]
    np.testing.assert_allclose(topt.state[tp]["sum_of_squares"].numpy(),
                               acc.numpy(), rtol=RTOL)
    with pytest.raises(ValueError):
        adagrad_state_from_jax({"w": np.zeros(3)}, {"w": (6, 3)})
    with pytest.raises(ValueError):
        lazy_adam_state_from_jax(np.zeros((3, 2)), np.zeros((3, 2)),
                                 np.zeros(2))


def test_make_optimizer_builds_lazy_adam_without_a_dense_step():
    p = {"a": torch.nn.Parameter(torch.zeros(3, 2))}
    opt = make_optimizer("lazy_adam", p, 0.1)
    assert isinstance(opt, toptim.LazyAdam)
    with pytest.raises(TypeError, match="no dense step"):
        opt.step()
    assert isinstance(make_optimizer("adam", p, 0.1), torch.optim.Adam)
    with pytest.raises(ValueError):
        make_optimizer("sgd", p, 0.1)


# ------------------------------------------------------ BPRMF's lazy step

@pytest.fixture(scope="module")
def small_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_optim")
    return str(root), jax_synthetic.make_dataset_dir(
        str(root), num_users=50, num_items=80, num_ratings=1200, seed=3)


def test_bprmf_lazy_step_matches_jax(small_data, monkeypatch):
    """JAX's weights and lazy state (converted) in both, then three fixed
    batches with repeated rows and padded rows of weight 0: losses,
    tables, moments and counts agree; rows no batch touched stay bit for
    bit."""
    root, data = small_data
    monkeypatch.chdir(root)
    cfg = dict(n_dim=8, lr=0.01, reg=0.05, batch_size=32,
               optimizer="lazy_adam")
    jm = JaxBPRMF(JaxRunConfig(recommender="BPRMF", data_dir=data, seed=1,
                               metric=("NDCG",), top_k=(10,)), dict(cfg))
    tm = BPRMF(RunConfig(data_dir=data, seed=1, metric=("NDCG",),
                         top_k=(10,)), dict(cfg), device="cpu")
    rng = np.random.default_rng(4)
    u, n, d = jm.num_users, jm.num_items, 8
    params = {"user_emb": rng.standard_normal((u, d)).astype(np.float32),
              "item_emb": rng.standard_normal((n, d)).astype(np.float32),
              "item_bias": rng.standard_normal(n).astype(np.float32)}
    states = [_state(rng, params[k].shape) for k in BPRMF._JAX_PARAMS]
    carry = ({k: jnp.asarray(v) for k, v in params.items()},
             tuple(joptim.LazyAdamState(*map(jnp.asarray, s))
                   for s in states))
    tm.load_jax_params(params)
    tm.load_jax_opt_state(*states)
    touched = {"user_emb": set(), "item_emb": set()}
    step = jax.jit(jm._train_step)
    for _ in range(3):
        b = 32
        batch = (rng.integers(0, u // 2, b), rng.integers(0, n // 2, b),
                 rng.integers(0, n // 2, (b, 1)),
                 (np.arange(b) < 28).astype(np.float32))
        touched["user_emb"] |= set(batch[0].tolist())
        touched["item_emb"] |= set(batch[1].tolist()) | set(
            batch[2][:, 0].tolist())
        carry, ref_loss = step(carry, (jnp.asarray(batch[0].astype(np.int32)),
                                       jnp.asarray(batch[1].astype(np.int32)),
                                       jnp.asarray(batch[2].astype(np.int32)),
                                       jnp.asarray(batch[3])))
        loss = tm.train_step(tuple(_t(x) for x in batch))
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    for i, key in enumerate(BPRMF._JAX_PARAMS):
        got = getattr(tm, key).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(carry[0][key]), rtol=RTOL,
                                   atol=ATOL)
        live = tm.optimizer.states[key]
        for field in ("m", "v", "counts"):
            np.testing.assert_allclose(
                getattr(live, field).numpy(),
                np.asarray(getattr(carry[1][i], field)), rtol=RTOL, atol=ATOL)
        rows = touched["user_emb" if key == "user_emb" else "item_emb"]
        untouched = np.setdiff1d(np.arange(got.shape[0]), list(rows))
        assert np.array_equal(got[untouched], params[key][untouched])
        for field, before in zip(("m", "v", "counts"), states[i]):
            assert np.array_equal(getattr(live, field).numpy()[untouched],
                                  before[untouched])
    for key in BPRMF._JAX_PARAMS:
        assert getattr(tm, key).grad is None        # no (N, d) gradient
    with pytest.raises(TypeError, match="no dense step"):
        tm.optimizer.step()
