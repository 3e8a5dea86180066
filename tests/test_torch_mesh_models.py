"""Every model of the port on a (2, 2) mesh of 4 gloo ranks on the CPU
against the port's single-device fit() at the same seed: the metrics of
the best epoch within rtol 1e-5, every parameter, gathered whole, within
1e-5 of its table's largest magnitude, and the epoch losses. Also, on the
trained mesh models, ``predict_topk`` of every model that has one against
the masked full top-k (values within 1e-6, ids equal) and the "topk"
evaluation against "full". The ranks are spawned once for the module (one
``run_ranks`` call runs every model in turn); each runs one thread.

The graph family shards its propagation over the 4 ranks (kernel #11 on
each rank's edges), the towers rank through the two-stage top-k (#1-#5),
FPMC, TransRec, SGAT and MGCN split their tables over the model axis, and
the rest train data-parallel.
"""
import os

import numpy as np
import pytest
import torch

from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.io import synthetic
from skrx_torch.ops.metrics import mask_items, topk_scores_and_indices
from skrx_torch.parallel import run_ranks

SHAPE = (2, 2)
RUN = dict(file_column="UIRT", sep="\t", metric=("Recall", "NDCG"),
           top_k=(5, 10), test_batch_size=16, seed=2021)
GRAPH = dict(lr=0.01, batch_size=128, epochs=2, early_stop=2)
# name -> model config: small widths, two epochs of a few steps each
CASES = {
    "Pop": {},
    "BPRMF": dict(lr=0.05, n_dim=8, batch_size=128, epochs=2, early_stop=2),
    "LightGCN": dict(embed_size=8, n_layers=2, **GRAPH),
    "AOBPR": dict(lr=0.05, embed_size=8, batch_size=128, epochs=2,
                  early_stop=2),
    "CML": dict(lr=0.05, embed_size=8, dns=3, batch_size=128, epochs=2,
                early_stop=2),
    "DENS": dict(dim=8, context_hops=2, K=2, n_negs=3, ns="dens",
                 edge_dropout=True, mess_dropout=True, **GRAPH),
    "SelfCF": dict(embed_dim=8, n_layers=2, **GRAPH),
    "LayerGCN": dict(embed_dim=8, n_layers=2, dropout=0.1, **GRAPH),
    "LightGCL": dict(d=8, gnn_layer=2, svd_q=4, dropout=0.25, **GRAPH),
    "CDAE": dict(lr=0.01, hidden_dim=8, dropout=0.2, num_neg=2,
                 batch_size=16, epochs=2, early_stop=2),
    "MultVAE": dict(lr=0.01, p_dims=[8, 16], batch_size=16, epochs=2,
                    early_stop=2),
    "FPMC": dict(lr=0.05, embed_size=8, batch_size=128, epochs=2,
                 early_stop=2),
    "TransRec": dict(lr=0.01, embed_size=8, batch_size=128, epochs=2,
                     early_stop=2),
    "SGAT": dict(lr=0.01, embed_size=8, n_layers=2, n_seqs=3, n_next=1,
                 batch_size=128, epochs=2, early_stop=2),
    "Caser": dict(lr=0.01, embed_size=8, seq_L=4, seq_T=2, nv=2, nh=4,
                  batch_size=128, epochs=2, early_stop=2),
    "HGN": dict(lr=0.01, seq_L=4, seq_T=2, embed_size=8, batch_size=128,
                epochs=2, early_stop=2),
    "GRU4Rec": dict(lr=0.01, layers=[8], batch_size=16, epochs=2,
                    early_stop=2, final_act="relu"),
    "GRU4RecPlus": dict(lr=0.01, layers=[8], batch_size=16, n_sample=16,
                        epochs=2, early_stop=2),
    "SASRec": dict(lr=0.01, hidden_units=8, max_len=10, num_blocks=1,
                   num_heads=1, batch_size=16, epochs=2, early_stop=2),
    "BERT4Rec": dict(lr=0.01, h_size=8, max_seq_len=8, n_layers=1,
                     att_heads=1, batch_size=16, epochs=2, early_stop=2),
    "SRGNN": dict(lr=0.01, hidden_size=8, step=1, max_seq_len=10,
                  batch_size=32, epochs=2, early_stop=2),
    "BM3": dict(embed_dim=8, n_layers=1, **GRAPH),
    "SLMRec": dict(rec_dim=8, layer_num=2, ssl_task="FAC", **GRAPH),
    "FREEDOM": dict(embed_dim=8, feat_dim=8, knn_k=5, **GRAPH),
    "MGCN": dict(embed_dim=8, knn_k=5, **GRAPH),
    "LATTICE": dict(embed_dim=8, feat_embed_dim=8, weight_size=[8, 8],
                    knn_k=5, **GRAPH),
}
# metric tolerance where the per-step reduction order differs more
METRIC_RTOL = {"LightGCL": 1e-3}
# biases whose exact gradient is 0: each shifts every logit of a softmax
# row alike (the attention's key bias; SLMRec's biases of the column side
# of two in-batch softmaxes), so they change no output and move only by
# rounding noise that Adam magnifies, differently under any other
# summation order; their models' outputs are held by the metrics
NOISE_DRIVEN = {"SASRec": ("blocks.0.att.k.b",), "BERT4Rec": ("blocks.0.k.b",),
                "SLMRec": ("g_v_iv.b", "g_t_ivat.b")}


def build(name, data, cfg, **run):
    reg = ModelRegistry()
    reg.load_skrx_model(name)
    return reg.get_model(name)[0](RunConfig(data_dir=data, **RUN, **run),
                                  dict(cfg), device="cpu")


def fit_report(m) -> dict:
    """What a fit model gives back: the best epoch's metrics, the epoch
    losses and the parameters, whole."""
    best = m.fit()
    return {"best": dict(best.results),
            "losses": [h["loss"] for h in m.history],
            "params": {k: v.numpy() for k, v in m.full_params().items()}}


def topk_report(m) -> dict:
    """The model's predict_topk on 16 users against its masked full top-k,
    and its "topk" evaluation against "full" (every rank calls this)."""
    out = {}
    if hasattr(m, "predict_topk"):
        users = np.arange(16)
        width = getattr(m, "_eval_width", None) or m.num_items
        train = torch.as_tensor(m.evaluator._tables_for(users, width)[0])
        vals, ids = m.predict_topk(users, 10, train)
        ref_v, ref_i = topk_scores_and_indices(
            mask_items(torch.as_tensor(m.predict(users)), train), 10)
        out["topk"] = (vals.numpy(), ids.numpy(), ref_v.numpy(),
                       ref_i.numpy())
        m.evaluator.eval_mode = "topk"
        out["topk_report"] = dict(m.evaluate().results)
    m.evaluator.eval_mode = "full"
    out["full_report"] = dict(m.evaluate().results)
    return out


def _mesh_rank(rank, names, data, work):
    torch.manual_seed(0)
    os.chdir(work)
    out = {}
    for name in names:
        m = build(name, data, CASES[name], mesh_shape=SHAPE)
        out[name] = fit_report(m)
        out[name].update(topk_report(m))
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh_models"))
    return root, synthetic.make_dataset_dir(
        root, num_users=48, num_items=72, num_ratings=1300, seed=11,
        with_mm=True, img_dim=12, txt_dim=10)


@pytest.fixture(scope="module")
def runs(data):
    """The single-device fit() of every case here, and the 4 ranks' run of
    every case on the (2, 2) mesh."""
    root, path = data
    work = os.path.join(root, "work")
    os.makedirs(work)
    cwd = os.getcwd()
    os.chdir(work)
    single = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name, cfg in CASES.items():
            single[name] = fit_report(build(name, path, cfg))
    finally:
        torch.set_num_threads(threads)
        os.chdir(cwd)
    ranks = run_ranks(_mesh_rank, SHAPE[0] * SHAPE[1],
                      (list(CASES), path, work), timeout=600)
    return single, ranks


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_fit_equals_single_device(runs, name):
    """Every rank's best metrics, epoch losses and whole parameters equal
    the single device's fit()."""
    single, ranks = runs
    ref = single[name]
    rtol = METRIC_RTOL.get(name, 1e-5)
    for r in ranks:
        got = r[name]
        assert got["best"].keys() == ref["best"].keys()
        np.testing.assert_allclose(list(got["best"].values()),
                                   list(ref["best"].values()), rtol=rtol,
                                   atol=1e-7, err_msg=name)
        if ref["losses"] and ref["losses"][0] is not None:
            np.testing.assert_allclose(got["losses"], ref["losses"],
                                       rtol=1e-5, atol=1e-7, err_msg=name)
        assert got["params"].keys() == ref["params"].keys()
        for key, want in ref["params"].items():
            if key in NOISE_DRIVEN.get(name, ()):
                assert np.isfinite(got["params"][key]).all()
                continue
            scale = max(float(np.abs(want).max()), 1e-30)
            np.testing.assert_allclose(got["params"][key], want, rtol=0,
                                       atol=1e-5 * scale,
                                       err_msg=f"{name} {key}")


@pytest.mark.parametrize("name", [n for n in CASES if n != "Pop"])
def test_mesh_predict_topk_equals_the_masked_full_topk(runs, name):
    """predict_topk on the mesh (catalog split over the model axis, #1-#5)
    equals the top-k of the masked full scores: values within 1e-6, ids
    equal where the value is finite."""
    for r in runs[1]:
        vals, ids, ref_v, ref_i = r[name]["topk"]
        np.testing.assert_allclose(vals, ref_v, rtol=0, atol=1e-6,
                                   err_msg=name)
        finite = np.isfinite(ref_v)
        np.testing.assert_array_equal(ids[finite], ref_i[finite],
                                      err_msg=name)


@pytest.mark.parametrize("name", [n for n in CASES if n != "Pop"])
def test_mesh_topk_evaluation_equals_full(runs, name):
    for r in runs[1]:
        got, ref = r[name]["topk_report"], r[name]["full_report"]
        assert got.keys() == ref.keys()
        np.testing.assert_allclose(list(got.values()), list(ref.values()),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
