"""Time-ordered data in the port against the JAX package's, on the same
rows: the four time views (ties in time keep file order, users without
training rows, pre- and post- padding and truncation, the files read
through the dataset layer), ``_generate_time_order_positive_items`` at
(1, 1, None), (1, 1, pad), (3, 1, None) and (5, 3, pad), and the batch
contract of ``SequentialPairwiseEpochPipeline``: the padded examples equal
JAX's, every example once an epoch with its ``prev`` and ``pos`` aligned,
JAX's shapes, and no negative among the user's positives."""
import numpy as np
import pandas as pd
import pytest

jax = pytest.importorskip("jax")
import torch

from skrx.io import synthetic as jax_synthetic
from skrx.io.data_iterator import \
    _generate_time_order_positive_items as jax_time_order
from skrx.io.dataset import ImplicitFeedback as JaxImplicitFeedback
from skrx.io.dataset import RSDataset as JaxRSDataset
from skrx.models.pipeline import \
    SequentialPairwiseEpochPipeline as JaxSeqPipeline
from skrx.utils.generic import pad_sequences as jax_pad_sequences
from skrx_torch.io.data_iterator import _generate_time_order_positive_items
from skrx_torch.io.dataset import ImplicitFeedback, RSDataset
from skrx_torch.models.pipeline import (SequentialPairwiseEpochPipeline,
                                        epoch_generator)
from skrx_torch.utils import pad_sequences

CPU = torch.device("cpu")
NUM_USERS, NUM_ITEMS = 40, 70


@pytest.fixture(scope="module")
def split():
    """(jax train data, port train data, columns): 40 users x 70 items in
    file order, every 9th user without a row, times with ties inside a
    user, one user of a single row."""
    rng = np.random.default_rng(3)
    users, items, times = [], [], []
    for u in range(NUM_USERS):
        if u % 9 == 0:
            continue
        n = 1 if u == 5 else int(rng.integers(2, 18))
        users += [u] * n
        items += list(rng.choice(NUM_ITEMS, n, replace=False))
        times += list(rng.integers(0, 6, n))          # ties in time
    order = rng.permutation(len(users))
    cols = {"user": np.array(users, np.int64)[order],
            "item": np.array(items, np.int64)[order],
            "time": np.array(times, np.float64)[order]}
    jd = JaxImplicitFeedback(pd.DataFrame(cols), NUM_USERS, NUM_ITEMS)
    td = ImplicitFeedback(cols, NUM_USERS, NUM_ITEMS)
    return jd, td, cols


def _same_dict(got, ref):
    assert list(got) == list(ref)
    for u in ref:
        assert got[u].dtype == ref[u].dtype, u
        np.testing.assert_array_equal(got[u], ref[u], err_msg=str(u))


def test_time_views_match_jax(split):
    jd, td, _ = split
    got, ref = td.to_user_item_pairs_by_time(), jd.to_user_item_pairs_by_time()
    assert got.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    _same_dict(td.to_user_dict_by_time(), jd.to_user_dict_by_time())
    for max_len, pad in ((None, 0), (4, NUM_ITEMS), (30, -1)):
        for padding in ("pre", "post"):
            for truncating in ("pre", "post"):
                _same_dict(td.to_truncated_seq_dict(max_len, pad, padding,
                                                    truncating),
                           jd.to_truncated_seq_dict(max_len, pad, padding,
                                                    truncating))
    for max_len, pad in ((5, None), (1, None), (12, 99)):
        got = td.to_padded_seq_tensor(max_len, pad)
        ref = jd.to_padded_seq_tensor(max_len, pad)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    table, lengths = td.to_padded_seq_tensor(5)
    assert lengths[0] == 0 and (table[0] == NUM_ITEMS).all()   # no rows


def test_views_without_time_raise_as_in_jax(split):
    _, td, cols = split
    plain = ImplicitFeedback({k: cols[k] for k in ("user", "item")})
    jplain = JaxImplicitFeedback(pd.DataFrame({k: cols[k]
                                               for k in ("user", "item")}))
    for view in ("to_user_item_pairs_by_time", "to_user_dict_by_time"):
        with pytest.raises(ValueError, match="timestamps"):
            getattr(jplain, view)()
        with pytest.raises(ValueError, match="timestamps"):
            getattr(plain, view)()
    with pytest.raises(ValueError, match="timestamps"):
        plain.to_padded_seq_tensor(3)


def test_time_views_of_the_files_match_jax(tmp_path):
    data = jax_synthetic.make_dataset_dir(str(tmp_path), num_users=50,
                                          num_items=60, num_ratings=900,
                                          seed=4)
    jd = JaxRSDataset(data, "\t", "UIRT").train_data
    td = RSDataset(data, "\t", "UIRT").train_data
    _same_dict(td.to_user_dict_by_time(), jd.to_user_dict_by_time())
    np.testing.assert_array_equal(td.to_padded_seq_tensor(5)[0],
                                  jd.to_padded_seq_tensor(5)[0])


@pytest.mark.parametrize("max_len,padding,truncating",
                         [(None, "post", "post"), (3, "pre", "pre"),
                          (3, "post", "pre"), (3, "pre", "post"),
                          (7, "pre", "post")])
def test_pad_sequences_matches_jax(max_len, padding, truncating):
    rng = np.random.default_rng(1)
    seqs = [rng.integers(0, 9, n) for n in (0, 1, 3, 5, 6)]
    np.testing.assert_array_equal(
        pad_sequences(seqs, -1, max_len, padding, truncating),
        jax_pad_sequences(seqs, -1, max_len, padding, truncating))
    with pytest.raises(ValueError):
        pad_sequences(seqs, padding="mid")


@pytest.mark.parametrize("num_previous,num_next,pad",
                         [(1, 1, None), (1, 1, NUM_ITEMS), (3, 1, None),
                          (5, 3, NUM_ITEMS)])
def test_time_order_examples_match_jax(split, num_previous, num_next, pad):
    jd, _, _ = split
    user_dict = jd.to_user_dict_by_time()
    ref = jax_time_order(user_dict, num_previous, num_next, pad)
    got = _generate_time_order_positive_items(user_dict, num_previous,
                                              num_next, pad)
    assert dict(got[0]) == dict(ref[0])
    for a, b in zip(got[1:], ref[1:]):
        assert a.dtype == b.dtype == np.int32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    if pad is not None and num_previous + num_next > 2:
        assert (got[2] == pad).any()              # pre-padded windows
    with pytest.raises(ValueError):
        _generate_time_order_positive_items({}, num_previous, num_next, pad)


@pytest.mark.parametrize("num_previous,num_next,pad,batch_size",
                         [(1, 1, None, 64), (5, 3, NUM_ITEMS, 100),
                          (3, 1, None, 4096)])
def test_sequential_pipeline_batch_contract(split, num_previous, num_next,
                                            pad, batch_size):
    jd, td, _ = split
    jp = JaxSeqPipeline(jd, batch_size, num_previous=num_previous,
                        num_next=num_next, pad=pad)
    tp = SequentialPairwiseEpochPipeline(td, batch_size, CPU,
                                         num_previous=num_previous,
                                         num_next=num_next, pad=pad)
    assert (tp.num_batches, tp.num_examples, tp.num_neg) == \
        (jp.num_batches, jp.num_examples, jp.num_neg)
    for got, ref in ((tp._users, jp._users), (tp._pos, jp._pos),
                     (tp._w, jp._w), (tp._prev, jp._extra[0])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    _, users, prev, nxt = jax_time_order(jd.to_user_dict_by_time(),
                                         num_previous, num_next, pad)
    examples = sorted(zip(users.tolist(), map(tuple, prev.tolist()),
                          map(tuple, nxt.tolist())))
    positives = jd.to_user_dict()
    seen, perms = [], []
    for epoch in range(2):
        gen = epoch_generator(5, epoch, CPU)
        got, negs = [], []
        for users_b, pos, neg, w, prev_b in tp.batches(gen):
            b = users_b.shape[0]
            assert pos.shape == ((b,) if num_next == 1 else (b, num_next))
            assert neg.shape == (b, num_next) and prev_b.shape == \
                (b, num_previous) and w.shape == (b,)
            for i in np.flatnonzero(w.numpy()):
                got.append((int(users_b[i]), tuple(prev_b[i].tolist()),
                            tuple(pos[i].reshape(-1).tolist())))
                negs.append(neg[i].numpy())
                assert not np.isin(neg[i].numpy(),
                                   positives[int(users_b[i])]).any()
        assert sorted(got) == examples          # each once, aligned
        seen.append(np.concatenate(negs))
        perms.append([g[0] for g in got])
    assert not np.array_equal(seen[0], seen[1])   # drawn anew each epoch
    assert perms[0] != perms[1]
