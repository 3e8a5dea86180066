"""The mechanisms under every mesh model, on gloo ranks on the CPU:

* one batch's gradients on a (2, 1) mesh, after ``sync_gradients``, equal
  one device's on the whole batch: a replicated parameter read directly
  (SelfCF's predictor, SLMRec's projections of the rank's own item rows)
  summed once, and one read through a collective that already sums (the
  split tables, BPRMF's bias through ``lookup_rows``) not a second time;
  before the sum each rank holds only its slice's part;
* two ranks building SGAT into one empty data directory at once both read
  the JAX package's six graph arrays, and no half-written file is left;
* a tower's ``predict_topk`` without a mesh raises ``ValueError``, as the
  JAX package's assert does.

The ranks import no JAX; the tests import it only for the SGAT arrays.
"""
import glob
import os
import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist

from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.io import synthetic
from skrx_torch.parallel import data_parallel, local_rows, run_ranks
from skrx_torch.parallel.mesh import gather_rows

RUN = dict(file_column="UIRT", sep="\t", metric=("Recall", "NDCG"),
           top_k=(5, 10), test_batch_size=16, seed=2021)
GRAD_CASES = {
    "BPRMF": dict(lr=0.05, n_dim=8, batch_size=64),
    "SelfCF": dict(embed_dim=8, n_layers=2, dropout=0.0, batch_size=64),
    "SLMRec": dict(rec_dim=8, layer_num=2, ssl_task="FAC", batch_size=64),
}
B = 64
# SLMRec's biases of the column side of an in-batch softmax: their exact
# gradient is 0 (test_torch_mesh_models), so theirs is rounding noise
NOISE_DRIVEN = ("g_v_iv.b", "g_t_ivat.b")


def _build(name, data, cfg, **run):
    reg = ModelRegistry()
    reg.load_skrx_model(name)
    return reg.get_model(name)[0](RunConfig(data_dir=data, **RUN, **run),
                                  dict(cfg), device="cpu")


def _batch(m, name):
    """A fixed whole batch (users, items[, negatives], weights), its last
    rows padding."""
    rng = np.random.default_rng(5)
    users = torch.as_tensor(rng.integers(0, m.num_users, B))
    items = torch.as_tensor(rng.integers(0, m.num_items, B))
    w = torch.ones(B)
    w[-3:] = 0.0
    if name == "BPRMF":
        neg = torch.as_tensor(rng.integers(0, m.num_items, (B, 1)))
        return (users, items, neg, w), ()
    if name == "SelfCF":
        return (users, items, w), ((torch.ones(m.graph.num_edges), None,
                                    None),)
    return (users, items, w), ((None, None),)


def _grads(m, name, batch, extra):
    m.optimizer.zero_grad(set_to_none=True)
    m._loss(*batch, *extra).backward()
    return {k: p.grad.clone() for k, p in m.named_parameters()
            if p.grad is not None}


def _grad_rank(rank, data, work):
    os.chdir(work)
    out = {}
    for name, cfg in GRAD_CASES.items():
        m = _build(name, data, cfg, mesh_shape=(2, 1))
        batch, extra = _batch(m, name)
        with data_parallel(m.mesh):
            part = _grads(m, name, local_rows(batch), extra)
            m.sync_gradients()
        whole = {k: p.grad.clone() for k, p in m.named_parameters()
                 if p.grad is not None}
        gathered = {k: gather_rows(g, m._row_blocks.get(k)).numpy()
                    for k, g in whole.items()}      # split tables whole
        out[name] = {"part": {k: v.numpy() for k, v in part.items()},
                     "synced": gathered,
                     "split": sorted(m._row_blocks)}
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh_mechanisms"))
    return root, synthetic.make_dataset_dir(
        root, num_users=48, num_items=72, num_ratings=1300, seed=11,
        with_mm=True, img_dim=12, txt_dim=10)


@pytest.fixture(scope="module")
def grads(data):
    root, path = data
    work = os.path.join(root, "grads")
    os.makedirs(work)
    cwd = os.getcwd()
    os.chdir(work)
    single = {}
    try:
        for name, cfg in GRAD_CASES.items():
            m = _build(name, path, cfg)
            single[name] = {k: v.numpy()
                            for k, v in _grads(m, name,
                                               *_batch(m, name)).items()}
    finally:
        os.chdir(cwd)
    return single, run_ranks(_grad_rank, 2, (path, work), timeout=300)


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_gradients_sum_once_over_the_data_axis(grads, name):
    """After the sum every rank holds the single device's gradient of each
    parameter (a split table's rows gathered whole): not halved (a slice's
    part) nor doubled (a collective's sum summed again)."""
    single, ranks = grads
    ref = single[name]
    for r in ranks:
        got = r[name]["synced"]
        assert got.keys() == ref.keys()
        for key, want in ref.items():
            if key in NOISE_DRIVEN:
                continue
            scale = max(float(np.abs(want).max()), 1e-30)
            np.testing.assert_allclose(got[key], want, rtol=0,
                                       atol=1e-6 * scale,
                                       err_msg=f"{name} {key}")


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_replicated_gradients_are_parts_before_the_sum(grads, name):
    """Before the sum a replicated parameter read directly holds its
    slice's part, and the two ranks' parts add up to the whole; the split
    tables and BPRMF's bias, read through collectives, are whole already."""
    single, ranks = grads
    whole_before = {"BPRMF": ("user_emb", "item_emb", "item_bias")}
    ref = single[name]
    split = ranks[0][name]["split"]
    for key, want in ref.items():
        parts = [r[name]["part"][key] for r in ranks]
        if (key in split or key in whole_before.get(name, ())
                or key in NOISE_DRIVEN):
            continue
        scale = max(float(np.abs(want).max()), 1e-30)
        assert np.abs(parts[0] - want).max() > 1e-4 * scale, key
        np.testing.assert_allclose(parts[0] + parts[1], want, rtol=0,
                                   atol=1e-6 * scale, err_msg=key)
    if name == "BPRMF":
        np.testing.assert_allclose(ranks[0][name]["part"]["item_bias"],
                                   ref["item_bias"], rtol=0, atol=1e-7)


def _sgat_rank(rank, data, work):
    os.chdir(work)
    dist.barrier()                  # both ranks build at once
    m = _build("SGAT", data, dict(embed_size=8, n_layers=1),
               mesh_shape=(2, 1))
    return [t.cpu().numpy() for t in m.graph[:5]]


def test_two_ranks_build_the_sgat_cache_at_once(tmp_path):
    pytest.importorskip("jax")
    from skrx.models.SGAT import SGAT as JaxSGAT
    from skrx_torch.models.SGAT import _GRAPH_KEYS
    root = str(tmp_path)
    path = synthetic.make_dataset_dir(root, num_users=48, num_items=72,
                                      num_ratings=1300, seed=11)
    cache = os.path.join(root, "_sgat_data")
    assert not os.path.exists(cache)
    ranks = run_ranks(_sgat_rank, 2, (path, root), timeout=300)
    files = glob.glob(os.path.join(cache, "*", "*"))
    assert [os.path.basename(f) for f in files] == ["graph_elem.npz"]
    with np.load(files[0]) as blob:
        saved = [blob[k] for k in _GRAPH_KEYS]
    # the JAX package's SGAT builds its own file from a copy of the data
    jax_root = os.path.join(root, "jax")
    shutil.copytree(path, os.path.join(jax_root, os.path.basename(path)))
    jax_path = os.path.join(jax_root, os.path.basename(path))
    from skrx import RunConfig as JaxRunConfig
    cwd = os.getcwd()
    os.chdir(jax_root)
    try:
        JaxSGAT(JaxRunConfig(recommender="SGAT", data_dir=jax_path, **RUN),
                dict(embed_size=8, n_layers=1))
    finally:
        os.chdir(cwd)
    with np.load(glob.glob(os.path.join(jax_root, "_sgat_data", "*",
                                        "graph_elem.npz"))[0]) as blob:
        ref = [blob[k] for k in _GRAPH_KEYS]
    for got, want in zip(saved, ref):
        np.testing.assert_array_equal(got, want)
    for r in ranks:      # each rank's graph: the file's arrays, as int64
        for got, want in zip(r, ref[:5]):
            np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("name", ["SASRec", "CDAE", "SGAT"])
def test_tower_predict_topk_needs_a_model_axis(data, tmp_path, monkeypatch,
                                               name):
    monkeypatch.chdir(tmp_path)
    cfg = {"SASRec": dict(hidden_units=8, max_len=10),
           "CDAE": dict(hidden_dim=8), "SGAT": dict(embed_size=8)}[name]
    m = _build(name, data[1], cfg)
    with pytest.raises(ValueError, match="model axis is above 1"):
        m.predict_topk(np.arange(4), 5)
