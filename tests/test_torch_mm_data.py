"""Item features and kNN item graphs in the port against the JAX package's:
the generator's features bit for bit, ``MMData`` on a JAX-written
directory, ``skrx.ops.mm_graph`` (``cosine_knn``, ``knn_adj_edges``,
``cached_mm_edges`` with the image, the text or both tables), MGCN's
weighted edges and LATTICE's original graphs, at chunk sizes that do and
do not divide the catalog. Indices exactly, values within rtol 1e-5 /
atol 1e-6, on the data of ``tests/test_models_mm.py`` (50 users, 80 items,
1,500 ratings, 12-d image and 10-d text features)."""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from skrx.io import RSDataset as JaxRSDataset
from skrx.io import synthetic as jax_synthetic
from skrx.models.LATTICE import (_build_sim, _knn_weighted,
                                 _norm_laplacian_dense)
from skrx.models.MGCN import _weighted_knn_edges
from skrx.ops import mm_graph as jax_mm
from skrx_torch.io import MMData, RSDataset
from skrx_torch.io import synthetic
from skrx_torch.ops import mm_graph

TOL = dict(rtol=1e-5, atol=1e-6)
CHUNKS = (None, 1, 7, 16, 80)          # 80 is N; 7 and 16 do not divide


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_mm_data")
    return jax_synthetic.make_dataset_dir(str(root), num_users=50,
                                          num_items=80, num_ratings=1500,
                                          seed=9, with_mm=True, img_dim=12,
                                          txt_dim=10)


@pytest.fixture(scope="module")
def feats(data):
    ds = RSDataset(data, "\t", "UIRT")
    return ds.img_features, ds.txt_features


def _t(x):
    return None if x is None else torch.from_numpy(x)


def test_generator_features_equal_jax_bits(data, tmp_path):
    """The port's generator, at JAX's seed and item count, writes JAX's
    feature arrays bit for bit (its interactions differ)."""
    ref = JaxRSDataset(data, "\t", "UIRT")
    ref.set_logger(type("Quiet", (), {"info": staticmethod(lambda *_: None)}))
    n = ref.num_items
    out = synthetic.make_dataset_dir(str(tmp_path), num_users=50,
                                     num_items=n, num_ratings=1500, seed=9,
                                     with_mm=True, img_dim=12, txt_dim=10)
    got = RSDataset(out, "\t", "UIRT")
    assert got.num_items == n
    for name in ("img_features", "txt_features"):
        g, r = getattr(got, name), getattr(ref, name)
        assert g.dtype == r.dtype == np.float32 and g.shape == r.shape
        assert g.tobytes() == r.tobytes(), name
    assert (got.img_dim, got.txt_dim) == (12, 10)
    plain = synthetic.make_dataset_dir(str(tmp_path / "plain"), num_users=50,
                                       num_items=n, num_ratings=1500, seed=9)
    assert RSDataset(plain, "\t", "UIRT").img_features is None


def test_mmdata_on_a_jax_directory(data, tmp_path):
    ref = JaxRSDataset(data, "\t", "UIRT")
    ref.set_logger(type("Quiet", (), {"info": staticmethod(lambda *_: None)}))
    got = RSDataset(data, "\t", "UIRT")
    for name in ("img_features", "txt_features", "img_dim", "txt_dim",
                 "audio_features", "audio_dim"):
        g, r = getattr(got, name), getattr(ref, name)
        if isinstance(r, np.ndarray):
            np.testing.assert_array_equal(g, r)
        else:
            assert g == r, name
    assert got.audio_features is None and got.audio_dim is None
    assert got.img_features.shape == (got.num_items, 12)
    mm = MMData(data)
    assert mm.statistic_info == ref.mm_data.statistic_info
    assert "image features: (" in got.statistic_info
    # a directory with the image table alone
    name = os.path.basename(data)
    lone = tmp_path / name
    lone.mkdir()
    np.savez(lone / f"{name}.img.npz", np.ones((3, 2), np.float32))
    mm = MMData(str(lone))
    assert mm.img_dim == 2 and mm.txt_features is None and mm.txt_dim is None


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("k", [1, 5, 10])
def test_cosine_knn_and_edges_equal_jax(feats, chunk, k):
    for x in feats:
        np.testing.assert_array_equal(
            mm_graph.cosine_knn(_t(x), k, chunk).numpy(),
            jax_mm.cosine_knn(x, k))
        rows, cols, vals = mm_graph.knn_adj_edges(_t(x), k, chunk)
        r_rows, r_cols, r_vals = jax_mm.knn_adj_edges(x, k)
        np.testing.assert_array_equal(rows.numpy(), r_rows)
        np.testing.assert_array_equal(cols.numpy(), r_cols)
        np.testing.assert_allclose(vals.numpy(), r_vals, **TOL)
        np.testing.assert_allclose(
            mm_graph.normalized_laplacian_values(rows, cols, len(x)).numpy(),
            jax_mm.normalized_laplacian_values(r_rows, r_cols, len(x)),
            **TOL)


@pytest.mark.parametrize("which", ["image", "text", "both"])
def test_cached_mm_edges_equal_jax(feats, which, tmp_path):
    """The blend (image weight 0.1 on the image graph, a table alone
    unweighted), built and then read back from the port's own cache file,
    which JAX's cache never reads."""
    img = feats[0] if which != "text" else None
    txt = feats[1] if which != "image" else None
    ref = jax_mm.cached_mm_edges(str(tmp_path / "jax"), "freedomdsp", 5,
                                 img, txt, 0.1)
    cache = str(tmp_path / "torch")
    for _ in range(2):                   # built, then loaded
        got = mm_graph.cached_mm_edges(cache, "freedomdsp", 5, _t(img),
                                       _t(txt), 0.1)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), r, **TOL)
        assert got[0].dtype == got[1].dtype == torch.int64
    assert os.listdir(cache) == ["torch_mm_adj_freedomdsp_5_w0.1.npz"]
    with pytest.raises(ValueError):
        mm_graph.mm_edges(None, None, 5)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_mgcn_weighted_edges_equal_jax(feats, chunk):
    for x in feats:
        got = mm_graph.weighted_knn_edges(_t(x), 5, chunk)
        for g, r in zip(got, _weighted_knn_edges(x, 5)):
            np.testing.assert_allclose(g.numpy(), r, **TOL)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_lattice_originals_equal_jax_dense(feats, chunk):
    """The sparse original graph holds the nonzeros of JAX's dense one and
    nothing else: scattered back it equals the dense matrix, zeros
    included."""
    for x in feats:
        rows, cols, vals = mm_graph.lattice_original_edges(_t(x), 5, chunk)
        ref = np.asarray(_norm_laplacian_dense(_knn_weighted(
            _build_sim(jnp.asarray(x)), 5)))
        dense = np.zeros_like(ref)
        np.add.at(dense, (rows.numpy(), cols.numpy()), vals.numpy())
        assert np.count_nonzero(dense) == np.count_nonzero(ref) == len(vals)
        np.testing.assert_allclose(dense, ref, **TOL)


def test_knn_values_and_rowsum_guard():
    """The learned graph's values are the selected similarities, with a
    gradient; ``inv_sqrt_positive`` is 0 where a row sum is not positive
    and its gradient finite everywhere."""
    x = torch.randn(20, 6, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    norm = mm_graph.l2_normalize(x)
    sims, ids = mm_graph.knn_select(x, 4)
    rows = torch.arange(20).repeat_interleave(4)
    vals = mm_graph.knn_values(norm, rows, ids.reshape(-1))
    np.testing.assert_allclose(vals.detach().numpy(),
                               sims.reshape(-1).numpy(), **TOL)
    vals.sum().backward()
    assert bool(torch.isfinite(x.grad).all()) and x.grad.abs().sum() > 0
    s = torch.tensor([4.0, 0.0, -1.0], requires_grad=True)
    d = mm_graph.inv_sqrt_positive(s)
    assert d.tolist() == [0.5, 0.0, 0.0]
    d.sum().backward()
    assert s.grad.tolist() == [-0.0625, 0.0, 0.0]
