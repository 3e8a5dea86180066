"""The rest of the JAX package's public surface in the port, each piece
against the JAX function on the same numpy inputs: the export lists, the
top-k and paged evaluation helpers, the graph utilities, the frame loader,
MovieLens-100k, the models' names, the pickle view cache, the card's peaks,
the example and the long-run sweep's reference."""
import importlib
import importlib.util
import os
import zipfile

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")

import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX names with another name in the port: the JAX package splits its
# model base into an abstract interface and a JAX epoch-loop harness; the
# port has one base class, an nn.Module with the epoch loop
RENAMED = {
    ("skrx.models", "JaxRecommender"): "TorchRecommender",
    ("skrx.models", "AbstractRecommender"): "TorchRecommender",
}


@pytest.mark.parametrize("module", ["", ".io", ".ops", ".utils", ".models"])
def test_every_exported_name_is_ported(module):
    ref = importlib.import_module("skrx" + module)
    port = importlib.import_module("skrx_torch" + module)
    missing = []
    for name in ref.__all__:
        target = RENAMED.get(("skrx" + module, name), name)
        if not hasattr(port, target) or target not in port.__all__:
            missing.append(name)
    assert not missing, missing


def _scores(rng, b, n):
    # distinct finite values: no ties, no signed zeros
    return rng.permutation(b * n).reshape(b, n).astype(np.float32) / (b * n)


def test_topk_from_scores_and_masked_topk_indices_match_jax():
    from skrx.ops import metrics as jm
    from skrx_torch.ops import metrics as tm
    rng = np.random.default_rng(3)
    scores = _scores(rng, 6, 300)
    mask = np.full((6, 12), 300, np.int32)
    mask[:, :9] = rng.integers(0, 300, (6, 9))
    np.testing.assert_array_equal(
        tm.topk_from_scores(torch.from_numpy(scores), 10).numpy(),
        np.asarray(jm.topk_from_scores(jnp.asarray(scores), 10)))
    np.testing.assert_array_equal(
        tm.masked_topk_indices(torch.from_numpy(scores),
                               torch.from_numpy(mask), 10).numpy(),
        np.asarray(jm.masked_topk_indices(jnp.asarray(scores),
                                          jnp.asarray(mask), 10)))


def test_eval_score_matrix_device_paged_matches_jax():
    from skrx.ops import metrics as jm
    from skrx_torch.ops import metrics as tm
    rng = np.random.default_rng(5)
    g, b, n, k = 3, 4, 300, 20
    scores = _scores(rng, g * b, n).reshape(g, b, n)
    train = np.full((g, b, 15), n, np.int32)
    train[..., :10] = rng.integers(0, n, (g, b, 10))
    test = np.full((g, b, 6), n, np.int32)
    test_len = rng.integers(1, 7, (g, b)).astype(np.int32)
    for i in np.ndindex(g, b):
        test[i][:test_len[i]] = rng.choice(n, test_len[i], replace=False)
    ids = (1, 2, 3, 4, 5)
    got = tm.eval_score_matrix_device_paged(
        *(torch.from_numpy(a) for a in (scores, train, test, test_len)),
        ids, k)
    ref = jm.eval_score_matrix_device_paged(
        *(jnp.asarray(a) for a in (scores, train, test, test_len)), ids, k,
        use_pallas=False)
    assert got.shape == (g, b, len(ids), k)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    one = tm.eval_score_matrix_device(
        *(torch.from_numpy(a[1]) for a in (scores, train, test, test_len)),
        ids, k)
    assert torch.equal(got[1], one)


def test_sp_mat_to_edges_and_build_ui_adjacency_match_jax():
    from skrx.utils import common as jc
    from skrx_torch.utils import build_ui_adjacency, sp_mat_to_edges
    rng = np.random.default_rng(7)
    users, items = rng.integers(0, 20, 90), rng.integers(0, 30, 90)
    for norm, loop in (("symmetric", False), ("left", True)):
        got = build_ui_adjacency(users, items, 20, 30, norm, loop)
        ref = jc.build_ui_adjacency(users, items, 20, 30, norm, loop)
        assert (got != ref).nnz == 0 and got.dtype == ref.dtype
        for a, r in zip(sp_mat_to_edges(got), jc.sp_mat_to_edges(ref)):
            assert a.dtype == r.dtype
            np.testing.assert_array_equal(a, r)


def test_load_dataframe_writes_jax_files(tmp_path):
    import filecmp
    from skrx.io import Preprocessor as JaxPreprocessor
    from skrx_torch.io import Preprocessor
    rng = np.random.default_rng(9)
    n = 400
    frame = pd.DataFrame({"u": rng.integers(0, 30, n),
                          "i": rng.integers(0, 40, n),
                          "r": rng.integers(1, 6, n),
                          "t": rng.integers(0, 99, n)})
    out = {}
    for tag, cls, df in (("jax", JaxPreprocessor, frame),
                         ("torch", Preprocessor, frame),
                         ("dict", Preprocessor,
                          {k: frame[k].to_numpy() for k in frame.columns})):
        p = cls()
        p.load_dataframe(df, columns="UIRT", name="frame",
                         dir_path=str(tmp_path))
        p.drop_duplicates()
        p.filter_data(user_min=3, item_min=2)
        p.remap_data_id()
        p.split_data_by_leave_out(valid=1, test=1)
        out[tag] = p.save_data(str(tmp_path / tag))
    names = sorted(os.listdir(out["jax"]))
    for tag in ("torch", "dict"):
        assert sorted(os.listdir(out[tag])) == names
        for name in names:
            assert filecmp.cmp(os.path.join(out["jax"], name),
                               os.path.join(out[tag], name),
                               shallow=False), (tag, name)


def test_movielens_extracts_a_local_zip(tmp_path):
    from skrx.io import MovieLens100k as JaxMovieLens
    from skrx_torch.io import MovieLens100k
    lines = "".join(f"{u}\t{i}\t{r}\t{t}\n" for u, i, r, t in
                    ((1, 2, 5, 881250949), (3, 4, 1, 891717742)))
    for tag in ("jax", "torch"):
        os.makedirs(tmp_path / tag)
        # the zip in place: download() finds it and fetches nothing
        with zipfile.ZipFile(tmp_path / tag / "ml-100k.zip", "w") as zf:
            zf.writestr("ml-100k/u.data", lines)
    got = MovieLens100k(str(tmp_path / "torch")).download_and_extract()
    ref = JaxMovieLens(str(tmp_path / "jax")).download_and_extract()
    assert os.path.basename(got) == os.path.basename(ref) == "ml-100k.rating"
    with open(got) as f, open(ref) as g:
        assert f.read() == g.read() == lines
    from skrx.io import movielens as jml
    from skrx_torch.io import movielens as tml
    assert tml._URL == jml._URL


def test_model_names_and_lazy_modules():
    import skrx.models as jmodels
    import skrx_torch.models as tmodels
    assert tmodels.MODEL_NAMES == jmodels.MODEL_NAMES
    assert tmodels.LightGCN.LightGCN.__name__ == "LightGCN"
    with pytest.raises(AttributeError):
        tmodels.NoSuchModel


@pytest.fixture
def small_data(tmp_path):
    from skrx_torch.io import synthetic
    return synthetic.make_dataset_dir(str(tmp_path), num_users=40,
                                      num_items=60, num_ratings=700, seed=3,
                                      latent_dim=4)


def _cached(path):
    from skrx_torch.io import CFData
    cf = CFData(path, "\t", "UIRT")
    name = os.path.basename(path)
    return cf, os.path.join(path, "_data_cache", f"torch_{name}_cf.pkl")


def _build_views(cf):
    cf.train_data.to_user_dict()
    cf.train_data.to_csr_matrix()
    cf.train_data.to_padded_positive_table()
    cf.test_data.to_user_dict_by_time()


def test_view_cache_restores_the_views(small_data):
    first, cache_file = _cached(small_data)
    _build_views(first)
    first._cache.save_from({"train": first.train_data,
                            "valid": first.valid_data,
                            "test": first.test_data})
    assert os.path.exists(cache_file)
    second, _ = _cached(small_data)
    views = second.train_data._views
    assert set(views) == set(first.train_data._views) and not views.dirty
    for key, value in first.train_data._views.items():
        if key == "user_dict":
            assert list(views[key]) == list(value)
            for u in value:
                np.testing.assert_array_equal(views[key][u], value[u])
        elif key == "csr":
            assert (views[key] != value).nnz == 0
        else:                                  # the padded table
            np.testing.assert_array_equal(views[key].table, value.table)
    # the restored views are the ones served
    assert second.train_data.to_user_dict() is views["user_dict"]
    assert list(second.test_data.to_user_dict_by_time()) == \
        list(first.test_data.to_user_dict_by_time())


def test_view_cache_rebuilds_after_train_changes(small_data):
    first, cache_file = _cached(small_data)
    _build_views(first)
    holders = {"train": first.train_data, "valid": first.valid_data,
               "test": first.test_data}
    first._cache.save_from(holders)
    train = os.path.join(small_data, os.path.basename(small_data) + ".train")
    later = os.path.getmtime(cache_file) + 10
    os.utime(train, (later, later))
    second, _ = _cached(small_data)
    assert len(second.train_data._views) == 0


def test_view_cache_corrupt_file_warns(small_data):
    first, cache_file = _cached(small_data)
    _build_views(first)
    first._cache.save_from({"train": first.train_data,
                            "valid": first.valid_data,
                            "test": first.test_data})
    with open(cache_file, "wb") as f:
        f.write(b"not a pickle")
    with pytest.warns(UserWarning, match="failed to restore data cache"):
        second, _ = _cached(small_data)
    assert len(second.train_data._views) == 0
    assert len(second.train_data.to_user_dict()) > 0


def test_chip_peaks_raise_for_an_unknown_card(monkeypatch):
    from skrx_torch.utils import chip
    assert chip.PEAKS["NVIDIA H100 80GB HBM3"] == (989e12, 67e12, 3.35e12)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=0: "NVIDIA H100 80GB HBM3")
    assert chip.chip_peaks()[1][2] == 3.35e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=0: "Some Other Card")
    with pytest.raises(KeyError, match="no published peaks"):
        chip.chip_peaks()


def test_example_runs_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    spec = importlib.util.spec_from_file_location(
        "run_synthetic_torch",
        os.path.join(ROOT, "examples", "run_synthetic_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out = example.main(["--device", "cpu", "--epochs", "8"])
    assert np.isfinite(out["BPRMF"]["NDCG@10"])
    assert out["BPRMF"]["NDCG@10"] > out["Pop"]["NDCG@10"]
    assert out["ids"].shape == (3, 5)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_longrun_sweep_is_jax_sweep_and_reference_bands_hold():
    jax_run = _load(os.path.join(ROOT, "scripts", "longrun.py"),
                    "skrx_longrun")
    port_run = _load(os.path.join(ROOT, "scripts", "longrun_torch.py"),
                     "skrx_torch_longrun")
    assert port_run.SWEEP == jax_run.SWEEP
    ref_mod = _load(os.path.join(ROOT, "experiments",
                                 "longrun_jax_reference.py"),
                    "longrun_jax_reference")
    ref = port_run.load_reference()
    assert ref["data"] == port_run.DATA
    for name, _, epochs in port_run.SWEEP:
        entry = ref["modes"]["sweep"]["models"][name]
        curves = list(entry["curves"].values())
        assert len(curves) == 3 and not entry["loss_nan"]
        bests = [ref_mod.best_through(c, entry["epochs"]) for c in curves]
        assert ref_mod.sweep_band(bests) == entry["band"]
        mu, half, lo, hi = port_run.band_at(ref, "sweep", name,
                                            entry["epochs"])
        last = [b[-1] for b in bests]
        assert mu == pytest.approx(np.mean(last))
        assert half == pytest.approx(max(2 * np.ptp(last),
                                         0.05 * np.mean(last)))
        assert lo <= min(last) <= max(last) <= hi
        assert port_run.best_through(curves[0], epochs) == max(
            v for _, v in curves[0])


def test_chip_smoke_phase18_cuts_have_reference_bands():
    """Each model of the sweep runs in phase 18 at a cut within its epochs
    where the reference has a band: JAX's seeds' interval for a model at
    the sweep's widths, JAX's one seed for a model at its defaults."""
    port_run = _load(os.path.join(ROOT, "scripts", "longrun_torch.py"),
                     "skrx_torch_longrun")
    cs = _load(os.path.join(ROOT, "chip_smoke.py"), "chip_smoke")
    ref = port_run.load_reference()
    assert set(cs.P18) == {name for name, _, _ in port_run.SWEEP}
    assert set(cs.P18_TWICE) <= set(cs.P18)
    for name, _, epochs in port_run.SWEEP:
        widths, cut = cs.P18[name]
        assert widths in ("sweep", "default") and 1 <= cut <= epochs
        mu, half, lo, hi = port_run.band_at(ref, widths, name, cut)
        assert lo < mu < hi and half > 0
