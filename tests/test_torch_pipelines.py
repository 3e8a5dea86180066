"""The port's InteractionEpochPipeline and UserVecEpochPipeline against the
JAX package's on the same training split: the padded examples, their
weights and the batch count; the users without positives left out;
``rows_for`` on padded rows and repeated users; each epoch a permutation
of the real examples, the same for the same generator, and ``run_epoch``'s
mean over steps."""
import numpy as np
import pandas as pd
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from skrx.io.dataset import ImplicitFeedback as JaxImplicitFeedback
from skrx.models.pipeline import InteractionEpochPipeline as JaxInteraction
from skrx.models.pipeline import UserVecEpochPipeline as JaxUserVec
from skrx_torch.io.dataset import ImplicitFeedback
from skrx_torch.models.pipeline import (InteractionEpochPipeline,
                                        UserVecEpochPipeline,
                                        epoch_generator)

CPU = torch.device("cpu")
NUM_USERS, NUM_ITEMS = 60, 90


@pytest.fixture(scope="module")
def split():
    """(jax train data, port train data): ~60 users x 90 items, every 7th
    user without a positive, one user holding 40 items."""
    rng = np.random.default_rng(4)
    pairs = {(int(u), int(i)) for u, i in zip(rng.integers(0, NUM_USERS, 900),
                                               rng.integers(0, NUM_ITEMS, 900))
             if u % 7}
    pairs |= {(3, int(i)) for i in rng.choice(NUM_ITEMS, 40, replace=False)}
    users, items = (np.array(c, dtype=np.int64) for c in zip(*sorted(pairs)))
    order = rng.permutation(len(users))           # file order, not sorted
    users, items = users[order], items[order]
    jd = JaxImplicitFeedback(pd.DataFrame({"user": users, "item": items}),
                             NUM_USERS, NUM_ITEMS)
    td = ImplicitFeedback({"user": users, "item": items}, NUM_USERS,
                          NUM_ITEMS)
    return jd, td


def _by_row(a: np.ndarray) -> np.ndarray:
    """The rows of ``a`` in lexicographic order."""
    return a[np.lexsort(a.T[::-1])]


@pytest.mark.parametrize("batch_size", [64, 100, 4096])
def test_interaction_pipeline_matches_jax(split, batch_size):
    jd, td = split
    jp = JaxInteraction(jd, batch_size)
    tp = InteractionEpochPipeline(td, batch_size, CPU)
    assert tp.num_batches == jp.num_batches and \
        tp.num_examples == jp.num_examples == len(td)
    np.testing.assert_array_equal(tp._users.numpy(), np.asarray(jp._users))
    np.testing.assert_array_equal(tp._pos.numpy(), np.asarray(jp._pos))
    np.testing.assert_array_equal(tp._w.numpy(), np.asarray(jp._w))
    padded = np.stack([tp._users.numpy(), tp._pos.numpy(),
                       tp._w.numpy().astype(np.int64)], 1)
    epochs = []
    for epoch in (0, 1, 0):
        batches = list(tp.batches(epoch_generator(5, epoch, CPU)))
        assert len(batches) == tp.num_batches
        for users, pos, w in batches:
            assert users.shape == pos.shape == w.shape == (batch_size,)
            assert users.dtype == pos.dtype == torch.int64
        got = np.concatenate([np.stack([u.numpy(), p.numpy(),
                                        w.numpy().astype(np.int64)], 1)
                              for u, p, w in batches])
        np.testing.assert_array_equal(_by_row(got), _by_row(padded))
        # every real pair exactly once, padding only with weight 0
        real = got[got[:, 2] == 1]
        assert len(real) == len(td) and len(np.unique(real[:, :2], axis=0)) \
            == len(real)
        epochs.append(got)
    assert np.array_equal(epochs[0], epochs[2])
    assert not np.array_equal(epochs[0], epochs[1])


@pytest.mark.parametrize("batch_size", [8, 16, 64])
def test_uservec_pipeline_matches_jax(split, batch_size):
    jd, td = split
    jp = JaxUserVec(jd, batch_size)
    tp = UserVecEpochPipeline(td, batch_size, CPU)
    assert tp.num_batches == jp.num_batches and \
        tp.num_examples == jp.num_examples
    np.testing.assert_array_equal(tp._users.numpy(), np.asarray(jp._users))
    np.testing.assert_array_equal(tp._w.numpy(), np.asarray(jp._w))
    np.testing.assert_array_equal(tp.pos_table.numpy(),
                                  np.asarray(jp._pos_table))
    empty = [u for u in range(NUM_USERS) if u % 7 == 0]
    real = tp._users.numpy()[tp._w.numpy() == 1]
    assert sorted(real) == [u for u in range(NUM_USERS) if u % 7]
    assert not np.isin(real, empty).any()
    dense = np.zeros((NUM_USERS, NUM_ITEMS), np.float32)
    pairs = td.to_user_item_pairs()
    dense[pairs[:, 0], pairs[:, 1]] = 1.0
    seen = []
    for users, rows, w in tp.batches(epoch_generator(2, 3, CPU)):
        assert rows.shape == (batch_size, NUM_ITEMS) and \
            rows.dtype == torch.float32
        np.testing.assert_array_equal(rows.numpy(), dense[users.numpy()])
        seen += users.numpy()[w.numpy() == 1].tolist()
    assert sorted(seen) == sorted(real)


def test_rows_for_matches_jax_on_padded_rows_and_repeated_users(split):
    jd, td = split
    jp, tp = JaxUserVec(jd, 16), UserVecEpochPipeline(td, 16, CPU)
    users = np.array([3, 3, 0, 7, 59, 1, 3, 14, 1], np.int64)  # 0, 7, 14: none
    ref = np.asarray(jp.rows_for(jnp.asarray(users, jnp.int32)))
    got = tp.rows_for(torch.from_numpy(users))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got[0].sum() == len(td.to_user_dict()[3]) >= 40
    assert got[2].sum() == got[3].sum() == got[7].sum() == 0
    assert torch.equal(got[0], got[1]) and torch.equal(got[0], got[6])


def test_run_epoch_returns_the_mean_of_the_step_losses(split):
    _, td = split
    for tp in (InteractionEpochPipeline(td, 64, CPU),
               UserVecEpochPipeline(td, 16, CPU)):
        losses = []

        def step(batch):
            losses.append(batch[-1].sum() + len(losses))
            return losses[-1]
        mean = tp.run_epoch(epoch_generator(1, 0, CPU), step)
        assert len(losses) == tp.num_batches
        np.testing.assert_allclose(mean, float(torch.stack(losses).mean()),
                                   rtol=1e-6)
