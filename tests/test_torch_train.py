"""The training slice: the port's losses, initializers, negative sampler,
epoch pipeline, BPRMF train step and fit() against the JAX package's, on
the same numpy-seeded inputs and data."""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from skrx import RunConfig as JaxRunConfig
from skrx.io import synthetic as jax_synthetic
from skrx.models import pipeline as jpipeline
from skrx.models.BPRMF import BPRMF as JaxBPRMF
from skrx.ops import initializers as jinit
from skrx.ops import losses as jlosses
from skrx.ops import sampling as jsampling
from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.convert import adam_state_from_jax
from skrx_torch.io import RSDataset
from skrx_torch.models import pipeline as tpipeline
from skrx_torch.models.BPRMF import BPRMF
from skrx_torch.ops import initializers as tinit
from skrx_torch.ops import losses as tlosses
from skrx_torch.ops import sampling as tsampling
from .parity_utils import assert_parity, run_seed


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------------- losses

def _loss_inputs(name, rng):
    a = rng.standard_normal((6, 8)).astype(np.float32)
    b = rng.standard_normal((6, 8)).astype(np.float32)
    y = rng.standard_normal(6).astype(np.float32) * 3
    yn = rng.standard_normal((6, 5)).astype(np.float32) * 3
    lab = (rng.random(6) < 0.5).astype(np.float32)
    return {
        "inner_product": (a, b), "euclidean_distance": (a, b),
        "l2_distance": (a, b), "bpr_loss": (y, yn[:, 0]), "l2_loss": (a, b),
        "sigmoid_cross_entropy": (y, lab), "square_loss": (y, lab),
        "hinge_loss": (y, yn[:, 0]), "top1_loss": (y, yn),
        "bpr_max_loss": (y, yn), "top1_max_loss": (y, yn),
        "info_nce_loss": (a, b), "log_loss": (y,),
    }[name]


@pytest.mark.parametrize("name", jlosses.__all__)
def test_losses_match_jax(name):
    args = _loss_inputs(name, np.random.default_rng(len(name)))
    ref = np.asarray(getattr(jlosses, name)(*map(jnp.asarray, args)))
    got = getattr(tlosses, name)(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_loss_options_match_jax():
    rng = np.random.default_rng(9)
    y, yn = (rng.standard_normal(s).astype(np.float32) for s in (6, (6, 5)))
    neg = rng.standard_normal((6, 3, 8)).astype(np.float32)
    a, b = (rng.standard_normal((6, 8)).astype(np.float32) for _ in "ab")
    for ref, got in (
            (jlosses.bpr_max_loss(jnp.asarray(y), jnp.asarray(yn), reg=0.3),
             tlosses.bpr_max_loss(_t(y), _t(yn), reg=0.3)),
            (jlosses.hinge_loss(jnp.asarray(y), jnp.asarray(yn[:, 0]), 0.5),
             tlosses.hinge_loss(_t(y), _t(yn[:, 0]), 0.5)),
            (jlosses.info_nce_loss(jnp.asarray(a), jnp.asarray(b), 0.5,
                                   jnp.asarray(neg)),
             tlosses.info_nce_loss(_t(a), _t(b), 0.5, _t(neg)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-7)


# ------------------------------------------------------------- initializers

@pytest.mark.parametrize("name", ["normal", "truncated_normal", "uniform",
                                  "he_normal", "he_uniform", "xavier_normal",
                                  "xavier_uniform", "zeros", "ones"])
def test_initializers_match_jax_in_shape_dtype_and_moments(name):
    """Different random streams: compare shape, dtype, mean, std and range
    on 100k draws."""
    shape = (400, 250)
    ref = np.asarray(jinit.get_initializer(name)(jax.random.key(0), shape))
    got = tinit.get_initializer(name)(shape, torch.Generator().manual_seed(0))
    assert got.shape == ref.shape and got.dtype == torch.float32
    got = got.numpy()
    std = max(ref.std(), 1e-12)
    assert abs(got.mean() - ref.mean()) <= 0.02 * std + 1e-7
    assert abs(got.std() - ref.std()) <= 0.02 * std
    assert abs(np.abs(got).max() - np.abs(ref).max()) <= 0.05 * std + 1e-7


def test_torch_layer_default_matches_jax_bounds():
    ref = np.asarray(jinit.torch_layer_default(jax.random.key(1), (300, 200),
                                               fan_in=64))
    got = tinit.torch_layer_default((300, 200), 64,
                                    torch.Generator().manual_seed(1)).numpy()
    for stat in (np.min, np.max, np.std):
        assert abs(stat(got) - stat(ref)) < 2e-3
    with pytest.raises(ValueError):
        tinit.get_initializer("glorot")


# ------------------------------------------------------------------ sampling

def _pos_table(rows, n):
    width = max(len(r) for r in rows)
    table = np.full((len(rows), width), n, np.int32)
    for i, r in enumerate(rows):
        table[i, :len(r)] = np.sort(r)
    return table


@pytest.mark.parametrize("p", [40, 3000])
def test_is_member_sorted_matches_jax(p):
    rng = np.random.default_rng(p)
    n = 4 * p
    rows = _pos_table([rng.permutation(n)[:rng.integers(1, p + 1)]
                       for _ in range(7)], n)
    q = rng.integers(0, n, (7, 33)).astype(np.int32)
    q[:, :3] = rows[:, :3]
    ref = np.asarray(jsampling.is_member_sorted(jnp.asarray(rows),
                                                jnp.asarray(q)))
    np.testing.assert_array_equal(
        tsampling.is_member_sorted(_t(rows), _t(q)).numpy(), ref)


def test_sample_negatives_takes_the_first_free_trial_else_the_last():
    """Replays the candidates from the same generator state: each negative
    is its first candidate outside the user's positives, or its last
    candidate when all 8 collide."""
    n, trials = 12, 8
    rows = _pos_table([np.arange(12), np.arange(10), np.array([3]),
                       np.arange(0, 12, 2)], n)
    users = _t(np.repeat(np.arange(4), 500))
    neg = tsampling.sample_negatives(torch.Generator().manual_seed(5), users,
                                     _t(rows), n, num_neg=2,
                                     num_trials=trials).numpy()
    cand = torch.randint(0, n, (len(users), 2 * trials),
                         generator=torch.Generator().manual_seed(5),
                         dtype=torch.int32).numpy().reshape(-1, 2, trials)
    pos = [set(r[r < n].tolist()) for r in rows]
    for i, u in enumerate(users.numpy()):
        for j in range(2):
            free = [c for c in cand[i, j] if c not in pos[u]]
            assert neg[i, j] == (free[0] if free else cand[i, j, -1])
    assert neg.dtype == np.int32 and neg.shape == (len(users), 2)


def test_sample_negatives_is_uniform_over_non_items():
    from scipy.stats import chisquare
    n = 60
    positives = np.array([0, 5, 6, 7, 30, 59])
    rows = _pos_table([positives], n)
    neg = tsampling.sample_negatives(
        torch.Generator().manual_seed(0), torch.zeros(60_000, dtype=torch.long),
        _t(rows), n).numpy().ravel()
    assert not np.isin(neg, positives).any()
    counts = np.bincount(neg, minlength=n)[np.setdiff1d(np.arange(n),
                                                        positives)]
    assert chisquare(counts).pvalue > 1e-3


def test_weighted_and_gumbel_samplers_follow_their_weights():
    from scipy.stats import chisquare
    n = 20
    w = np.arange(1, n + 1, dtype=np.float64)
    logw = _t(np.log(w).astype(np.float32))
    rows = _pos_table([np.array([19])], n)
    neg = tsampling.sample_negatives_weighted(
        torch.Generator().manual_seed(1), torch.zeros(40_000, dtype=torch.long),
        _t(rows), logw, num_neg=1).numpy().ravel()
    assert not (neg == 19).any()
    counts = np.bincount(neg, minlength=n)[:19]
    assert chisquare(counts, w[:19] / w[:19].sum() * counts.sum()
                     ).pvalue > 1e-3
    gen = torch.Generator().manual_seed(2)
    firsts = []
    for _ in range(4000):
        idx = tsampling.gumbel_topk_without_replacement(gen, logw, 5)
        assert len(set(idx.tolist())) == 5
        firsts.append(int(idx[0]))
    counts = np.bincount(firsts, minlength=n)
    assert chisquare(counts, w / w.sum() * counts.sum()).pvalue > 1e-3


def test_pad_to_batches_matches_jax():
    arr = np.arange(10, dtype=np.int32) + 3
    for bs in (3, 5, 16):
        for got, ref in zip(tpipeline.pad_to_batches(arr, bs),
                            jpipeline.pad_to_batches(arr, bs)):
            np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError):
        tpipeline.pad_to_batches(arr[:0], 4)


# ------------------------------------------------------- BPRMF train step

@pytest.fixture(scope="module")
def small_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train")
    return str(root), jax_synthetic.make_dataset_dir(
        str(root), num_users=50, num_items=80, num_ratings=1200, seed=3)


def test_epoch_pipeline_covers_every_pair_once(small_data):
    root, data = small_data
    train = RSDataset(data, "\t", "UIRT").train_data
    pipe = tpipeline.PairwiseEpochPipeline(train, 64, torch.device("cpu"))
    gen = tpipeline.epoch_generator(7, 0, torch.device("cpu"))
    seen, hits, table = [], 0, train.to_padded_positive_table().table
    for users, pos, neg, w in pipe.batches(gen):
        assert users.shape == pos.shape == w.shape == (64,)
        assert neg.shape == (64, 1)
        keep = w.numpy() > 0
        seen += list(zip(users.numpy()[keep], pos.numpy()[keep]))
        hits += sum(j in table[u] for u, j in zip(users.numpy(),
                                                  neg[:, 0].numpy()))
    pairs = train.to_user_item_pairs()
    # a positive only when all 8 trials collide: (n_pos / N) ** 8, under
    # 0.2% for the densest user here
    assert hits <= 0.01 * len(pairs)
    assert sorted(seen) == sorted(map(tuple, pairs.tolist()))
    assert pipe.num_batches == -(-len(pairs) // 64)
    a = [b[2] for b in pipe.batches(tpipeline.epoch_generator(7, 1, "cpu"))]
    c = [b[2] for b in pipe.batches(tpipeline.epoch_generator(7, 1, "cpu"))]
    assert all(torch.equal(x, y) for x, y in zip(a, c))


def test_adam_state_conversion_follows_ravel_order():
    from jax.flatten_util import ravel_pytree
    rng = np.random.default_rng(0)
    tree = {"user_emb": rng.standard_normal((3, 2)).astype(np.float32),
            "item_emb": rng.standard_normal((4, 2)).astype(np.float32),
            "item_bias": rng.standard_normal(4).astype(np.float32)}
    flat, _ = ravel_pytree({k: jnp.asarray(v) for k, v in tree.items()})
    shapes = {k: v.shape for k, v in tree.items()}
    state = adam_state_from_jax(7, np.asarray(flat), 2 * np.asarray(flat),
                                      shapes)
    for key, value in tree.items():
        np.testing.assert_array_equal(state[key]["exp_avg"].numpy(), value)
        np.testing.assert_array_equal(state[key]["exp_avg_sq"].numpy(),
                                      2 * value)
        assert float(state[key]["step"]) == 7.0
    with pytest.raises(ValueError):
        adam_state_from_jax(1, np.zeros(3), np.zeros(3), shapes)


def test_train_step_matches_jax(small_data, monkeypatch):
    """Same params and Adam state in both, then three fixed batches: the
    loss of each step and the parameters after it agree."""
    from jax.flatten_util import ravel_pytree
    root, data = small_data
    monkeypatch.chdir(root)
    cfg = dict(n_dim=8, lr=0.01, reg=0.05, batch_size=32)
    jm = JaxBPRMF(JaxRunConfig(recommender="BPRMF", data_dir=data, seed=1,
                               metric=("NDCG",), top_k=(10,)), dict(cfg))
    tm = BPRMF(RunConfig(data_dir=data, seed=1, metric=("NDCG",),
                         top_k=(10,)), dict(cfg), device="cpu")
    rng = np.random.default_rng(4)
    u, n, d = jm.num_users, jm.num_items, 8
    params = {"user_emb": rng.standard_normal((u, d)).astype(np.float32),
              "item_emb": rng.standard_normal((n, d)).astype(np.float32),
              "item_bias": rng.standard_normal(n).astype(np.float32)}
    flat, unravel = ravel_pytree({k: jnp.asarray(v)
                                  for k, v in params.items()})
    mu = rng.standard_normal(flat.shape[0]).astype(np.float32) * 0.05
    nu = rng.uniform(1e-3, 1e-2, flat.shape[0]).astype(np.float32)
    adam, *rest = jm.optimizer.init(flat)
    carry = (flat, (adam._replace(count=jnp.asarray(4, jnp.int32),
                                  mu=jnp.asarray(mu), nu=jnp.asarray(nu)),
                    *rest))
    tm.load_jax_params(params)
    tm.load_jax_opt_state(4, mu, nu)
    step = jax.jit(jm._train_step)
    for _ in range(3):
        b = 32
        batch = (rng.integers(0, u, b).astype(np.int32),
                 rng.integers(0, n, b).astype(np.int32),
                 rng.integers(0, n, (b, 1)).astype(np.int32),
                 (rng.random(b) < 0.9).astype(np.float32))
        carry, ref_loss = step(carry, tuple(map(jnp.asarray, batch)))
        loss = tm.train_step(tuple(_t(x.astype(np.int64)) if x.dtype ==
                                   np.int32 else _t(x) for x in batch))
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
        ref = unravel(carry[0])
        for key in params:
            np.testing.assert_allclose(getattr(tm, key).detach().numpy(),
                                       np.asarray(ref[key]), rtol=1e-5,
                                       atol=1e-6)


def test_sharded_train_step_is_not_ported():
    """The sharded step on a mesh of one process (no process group), its
    rows read by lookup_rows (a table split over the model axis of one
    rank, and a table every rank holds), is the single-device step with
    plain indexing, bit for bit: the lookup's backward sums as indexing's
    gradient does. The multi-rank step is held to one device in
    tests/test_torch_sharded_models.py."""
    from skrx_torch.models.common import (make_optimizer,
                                          make_sharded_train_step,
                                          make_train_step)
    from skrx_torch.parallel import lookup_rows, make_mesh, \
        model_row_sharding
    mesh = make_mesh(None, "cpu")
    assert (mesh.size, mesh.data_size, mesh.model_size) == (1, 1, 1)
    ids = torch.tensor([0, 2, 2, 5, 1, 2])
    steps = []
    for sharded in (False, True):
        rng = np.random.default_rng(3)
        table = torch.nn.Parameter(_t(rng.standard_normal((6, 3))
                                      .astype(np.float32)))
        bias = torch.nn.Parameter(_t(rng.standard_normal(6)
                                     .astype(np.float32)))
        opt = make_optimizer("adam", {"t": table, "b": bias}, 0.1)
        blocks = model_row_sharding(mesh, 6)

        def loss(ids):
            if sharded:
                rows = lookup_rows(table, ids, blocks, mesh)
                b = lookup_rows(bias, ids, None, mesh)
            else:
                rows, b = table[ids], bias[ids]
            return torch.sum(torch.sin(rows) * b[:, None])
        step = (make_sharded_train_step(opt, loss) if sharded
                else make_train_step(opt, loss))
        losses = [float(step((ids,))) for _ in range(3)]
        steps.append((losses, table.detach().clone(), bias.detach().clone()))
    assert steps[0][0] == steps[1][0]
    assert torch.equal(steps[0][1], steps[1][1])
    assert torch.equal(steps[0][2], steps[1][2])


# ------------------------------------------------------------------- fit()

def test_fit_lands_in_the_parity_band_of_jax_fit(tmp_path, monkeypatch):
    """BPRMF fit() against the JAX package's, both built by name with the
    same RunConfig and started from the same weights (JAX's, carried over
    with convert.py); the negatives and the order of steps come from
    different random streams. Best NDCG@10 and Recall@10 land in the
    two-sided band: over ten seeds at this size the ratio is 1.00 +- 0.03
    (lowest 0.96), so SKRX_PARITY_SEED 0, 1 and 2 all pass."""
    from skrx.utils import ModelRegistry as JaxModelRegistry
    monkeypatch.chdir(tmp_path)
    data = jax_synthetic.make_dataset_dir(str(tmp_path), num_users=600,
                                          num_items=400, num_ratings=18000,
                                          seed=13, latent_dim=4,
                                          latent_strength=8.0)
    cfg = dict(lr=0.01, reg=0.01, n_dim=16, batch_size=256, epochs=15,
               early_stop=15)
    run = dict(recommender="BPRMF", data_dir=data, file_column="UIRT",
               sep="\t", metric=("NDCG", "Recall"), top_k=(10,),
               test_batch_size=64, seed=run_seed())
    jreg, treg = JaxModelRegistry(), ModelRegistry()
    jreg.load_skrx_model("BPRMF")
    treg.load_skrx_model("BPRMF")
    jm = jreg.get_model("BPRMF")[0](JaxRunConfig(**run), dict(cfg))
    model = treg.get_model("BPRMF")[0](RunConfig(**run), dict(cfg),
                                       device="cpu")
    model.load_jax_params({k: np.asarray(v) for k, v in jm.params.items()})
    ref, got = jm.fit(), model.fit()
    assert_parity("bprmf_torch", got, ref)
    losses = [h["loss"] for h in model.history]
    assert len(losses) == 15 and losses[-1] < losses[0]
    assert os.listdir(os.path.join("log", os.path.basename(data), "BPRMF"))
