"""The port's numpy-only dataset layer against the JAX package's, on files
written by each package's synthetic generator."""
import numpy as np
import pytest

pytest.importorskip("jax")

from skrx.io import RSDataset as JaxRSDataset
from skrx.io import synthetic as jax_synthetic
from skrx_torch.io import RSDataset
from skrx_torch.io import synthetic


def _assert_same_views(path, columns="UIRT", max_pos_cap=None):
    ref = JaxRSDataset(path, "\t", columns)
    ref.set_logger(type("Quiet", (), {"info": staticmethod(lambda *_: None)}))
    got = RSDataset(path, "\t", columns)
    assert (got.num_users, got.num_items, got.num_ratings) == (
        ref.num_users, ref.num_items, ref.num_ratings)
    for split in ("train_data", "valid_data", "test_data"):
        r, g = getattr(ref, split), getattr(got, split)
        assert len(g) == len(r)
        np.testing.assert_array_equal(g.to_user_item_pairs(),
                                      r.to_user_item_pairs())
        rd, gd = r.to_user_dict(), g.to_user_dict()
        assert list(gd) == list(rd)
        for u in rd:
            np.testing.assert_array_equal(gd[u], rd[u])
    rp = ref.train_data.to_padded_positive_table(max_pos_cap=max_pos_cap)
    gp = got.train_data.to_padded_positive_table(max_pos_cap=max_pos_cap)
    np.testing.assert_array_equal(gp.table, rp.table)
    np.testing.assert_array_equal(gp.lengths, rp.lengths)
    assert gp.pad_id == rp.pad_id == ref.num_items


@pytest.mark.parametrize("columns,cap", [("UIRT", None), ("UI", None),
                                         ("UIRT", 4)])
def test_dataset_matches_jax_on_jax_generated_files(tmp_path, columns, cap):
    path = jax_synthetic.make_dataset_dir(str(tmp_path), num_users=60,
                                          num_items=90, num_ratings=1500,
                                          seed=7, columns=columns)
    _assert_same_views(path, columns, cap)


def test_synthetic_generator_layout_and_counts(tmp_path):
    u, n, r = 120, 300, 2500
    path = synthetic.make_dataset_dir(str(tmp_path), num_users=u,
                                      num_items=n, num_ratings=r, seed=3)
    ds = RSDataset(path, "\t", "UIRT")
    assert (ds.num_users, ds.num_items, ds.num_ratings) == (u, n, r)
    pairs = np.concatenate([getattr(ds, s).to_user_item_pairs()
                            for s in ("train_data", "valid_data",
                                      "test_data")])
    keys = pairs[:, 0].astype(np.int64) * n + pairs[:, 1]
    assert len(np.unique(keys)) == r                    # no duplicate pair
    per_user = np.bincount(pairs[:, 0], minlength=u)
    assert per_user.min() >= 3
    assert np.bincount(pairs[:, 1], minlength=n).min() >= 1
    train = np.bincount(ds.train_data.to_user_item_pairs()[:, 0],
                        minlength=u)
    np.testing.assert_array_equal(train, np.ceil(0.7 * per_user))
    # the JAX package reads the same files to the same views
    _assert_same_views(path)


def test_synthetic_split_is_time_ordered(tmp_path):
    path = synthetic.make_dataset_dir(str(tmp_path), num_users=40,
                                      num_items=80, num_ratings=600, seed=5)
    prefix = path + "/" + path.rstrip("/").split("/")[-1]
    cols = {s: np.loadtxt(f"{prefix}.{s}", delimiter="\t", dtype=np.int64,
                          ndmin=2) for s in ("train", "valid", "test")}
    for u in range(40):
        times = [cols[s][cols[s][:, 0] == u, 3] for s in
                 ("train", "valid", "test")]
        present = [t for t in times if len(t)]
        for a, b in zip(present, present[1:]):
            assert a.max() <= b.min()


def test_synthetic_rejects_impossible_sizes(tmp_path):
    with pytest.raises(ValueError):
        synthetic.make_interactions(num_users=100, num_items=50,
                                    num_ratings=200)


def test_csr_and_coo_views_match_jax_with_repeated_pairs():
    """to_csr_matrix / to_coo_matrix against the JAX dataset's on rows that
    repeat (user, item) pairs: the repeats summed, f32, the COO entries in
    the same (row-major) order; the CSR view built once."""
    import pandas as pd
    from skrx.io.dataset import ImplicitFeedback as JaxImplicitFeedback
    from skrx_torch.io.dataset import ImplicitFeedback
    rng = np.random.default_rng(0)
    users = rng.integers(0, 12, 300)
    items = rng.integers(0, 20, 300)
    ref = JaxImplicitFeedback(pd.DataFrame({"user": users, "item": items}),
                              13, 21)
    got = ImplicitFeedback({"user": users, "item": items}, 13, 21)
    csr, ref_csr = got.to_csr_matrix(), ref.to_csr_matrix()
    assert csr.shape == ref_csr.shape == (13, 21)
    assert csr.dtype == ref_csr.dtype == np.float32
    assert csr.max() > 1 and csr.sum() == len(users)         # summed repeats
    np.testing.assert_array_equal(csr.toarray(), ref_csr.toarray())
    assert got.to_csr_matrix() is csr
    coo, ref_coo = got.to_coo_matrix(), ref.to_coo_matrix()
    for field in ("row", "col", "data"):
        np.testing.assert_array_equal(getattr(coo, field),
                                      getattr(ref_coo, field))
    empty = ImplicitFeedback(None, 3, 4)
    assert empty.to_csr_matrix().shape == (3, 4)
    assert empty.to_coo_matrix().nnz == 0
