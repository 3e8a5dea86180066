"""LightGCN on a (1, 2) mesh and BPRMF on a (2, 2) mesh, 2 and 4 gloo ranks
on the CPU, against the JAX package's single-device fit() at the same seed:
the port starts from JAX's initial weights and trains on JAX's batches (its
pipeline's own draws, which each rank slices by data index), so the
parameters, the losses and the metrics of the sharded run must be the
single device's. Also the two-stage ``predict_topk`` against the full
top-k, ``eval_mode="topk"`` against "full", checkpoints gathered whole and
resumed, Pop and lazy-Adam BPRMF built under a mesh, and the command
line on 2 ranks. The ranks are spawned without JAX: this module imports it
only inside the tests."""
import glob
import os

import numpy as np
import pytest
import torch

from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.ops.metrics import mask_items, topk_scores_and_indices
from skrx_torch.parallel import run_ranks

RUN = dict(file_column="UIRT", sep="\t", metric=("Recall", "NDCG"),
           top_k=(5, 10), test_batch_size=16, seed=2021)
EPOCHS = 3
CASES = {
    "LightGCN": ((1, 2), dict(lr=0.01, reg=0.001, embed_size=16, n_layers=2,
                              batch_size=64, epochs=EPOCHS,
                              early_stop=EPOCHS)),
    "BPRMF": ((2, 2), dict(lr=0.05, reg=0.001, n_dim=16, batch_size=64,
                           epochs=EPOCHS, early_stop=EPOCHS)),
}


def _model(name, data, cfg, **run):
    reg = ModelRegistry()
    reg.load_skrx_model(name)
    return reg.get_model(name)[0](RunConfig(data_dir=data, **RUN, **run),
                                  dict(cfg), device="cpu")


def _replay(model, params0, batches):
    """Load JAX's initial weights and make the pipeline draw JAX's global
    batches, one a step, in order (the pipeline slices them)."""
    model.load_jax_params(params0)
    steps = iter(batches)
    model.pipeline._batch = lambda generator, idx: tuple(
        torch.tensor(a) for a in next(steps))


def _fit_rank(rank, name, data, work, shape, cfg, params0, batches):
    os.chdir(work)
    ckpt = os.path.join(work, "ckpt")
    m = _model(name, data, cfg, mesh_shape=shape, checkpoint_dir=ckpt,
               checkpoint_every=1)
    _replay(m, params0, batches)
    best = m.fit()
    out = {"best": dict(best.results),
           "losses": [h["loss"] for h in m.history],
           "params": {k: v.numpy() for k, v in m.full_params().items()},
           "local": {k: v.detach().numpy().copy()
                     for k, v in m.named_parameters()},
           "mode": m.evaluator.eval_mode, "tp": getattr(m, "_tp", None)}
    users = np.arange(16)
    train = torch.as_tensor(m.evaluator._tables_for(users, m.num_items)[0])
    vals, ids = m.predict_topk(users, 10, train)
    ref_v, ref_i = topk_scores_and_indices(
        mask_items(m.predict(users), train), 10)
    out["topk"] = (vals.numpy(), ids.numpy(), ref_v.numpy(), ref_i.numpy())
    out["topk_report"] = dict(m.evaluate().results)
    m.evaluator.eval_mode = "full"
    out["full_report"] = dict(m.evaluate().results)
    again = _model(name, data, cfg, mesh_shape=shape, checkpoint_dir=ckpt,
                   checkpoint_every=1, resume=True)
    again.fit()                 # restores epoch EPOCHS - 1, trains nothing
    out["resumed"] = {k: v.detach().numpy() for k, v in
                      again.named_parameters()}
    out["resumed_moments"] = [
        s["exp_avg"].numpy() for s in again.optimizer.state.values()]
    out["moments"] = [s["exp_avg"].numpy()
                      for s in m.optimizer.state.values()]
    if name == "BPRMF":
        lazy = _model(name, data, dict(cfg, optimizer="lazy_adam"),
                      mesh_shape=shape)
        out["lazy"] = (lazy._tp, dict(lazy._row_blocks),
                       tuple(lazy.user_emb.shape),
                       (lazy.num_users, cfg["n_dim"]))
    return out


def _main_rank(rank, argv, work):
    import run_skrx_torch
    os.chdir(work)
    return dict(run_skrx_torch.main(argv, device="cpu").results)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    pytest.importorskip("jax")
    from skrx.io import synthetic
    root = tmp_path_factory.mktemp("sharded_models")
    return str(root), synthetic.make_dataset_dir(
        str(root), num_users=48, num_items=72, num_ratings=1300, seed=11,
        latent_dim=4, latent_strength=6.0)


def _jax_fit(name, data, cfg, work):
    """JAX's single-device model at the seed: its initial weights, every
    epoch's batches as its fit() draws them, and its fit()."""
    import jax
    from skrx import RunConfig as JaxRunConfig
    from skrx.utils import ModelRegistry as JaxRegistry
    reg = JaxRegistry()
    reg.load_skrx_model(name)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        jm = reg.get_model(name)[0](
            JaxRunConfig(recommender=name, data_dir=data, **RUN),
            dict(cfg, **({"graph_impl": "segment"}
                         if name == "LightGCN" else {})))
        params0 = {k: np.asarray(v) for k, v in jm.params.items()}
        p = jm.pipeline
        batches = []
        for epoch in range(EPOCHS):
            key = jax.random.fold_in(jm._rng, epoch)
            arrays = [np.asarray(a) for a in p._prepare_batches(
                key, p._users, p._pos, p._w, p._pos_table)]
            for step in range(p.num_batches):
                u, pos, neg, w = (a[step] for a in arrays)
                batches.append((u.astype(np.int64), pos.astype(np.int64),
                                neg.astype(np.int64), w))
        best = jm.fit()
        params = {k: np.asarray(v) for k, v in jm.params.items()}
    finally:
        os.chdir(cwd)
    return params0, batches, dict(best.results), params


@pytest.fixture(scope="module", params=list(CASES))
def fitted(request, data):
    name = request.param
    root, path = data
    shape, cfg = CASES[name]
    work = os.path.join(root, name)
    os.makedirs(work)
    params0, batches, ref_best, ref_params = _jax_fit(name, path, cfg, work)
    single = _model(name, path, cfg, checkpoint_dir=os.path.join(
        work, "single"), checkpoint_every=1)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        _replay(single, params0, batches)
        single.fit()
    finally:
        os.chdir(cwd)
    ranks = run_ranks(_fit_rank, shape[0] * shape[1],
                      (name, path, work, shape, cfg, params0, batches),
                      timeout=400)
    return dict(name=name, shape=shape, work=work, ref_best=ref_best,
                ref_params=ref_params, single=single, ranks=ranks)


def test_sharded_fit_matches_jax_single_device(fitted):
    """Every rank's metrics and gathered parameters equal JAX's
    single-device fit(); the epoch losses equal the port's single
    device's."""
    losses = [h["loss"] for h in fitted["single"].history]
    for r in fitted["ranks"]:
        assert r["best"].keys() == fitted["ref_best"].keys()
        np.testing.assert_allclose(list(r["best"].values()),
                                   list(fitted["ref_best"].values()),
                                   rtol=0, atol=1e-6)
        for key, ref in fitted["ref_params"].items():
            np.testing.assert_allclose(r["params"][key], ref, rtol=1e-5,
                                       atol=1e-5, err_msg=key)
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
    assert fitted["ranks"][0]["mode"] == "auto"


def test_each_rank_holds_its_rows(fitted):
    """LightGCN's ranks hold their blocks of the node table, BPRMF's their
    model index's rows of each table and the whole bias; the blocks tile
    the single device's tables."""
    ranks, params = fitted["ranks"], fitted["ranks"][0]["params"]
    if fitted["name"] == "LightGCN":
        for key in ("user_emb", "item_emb"):
            np.testing.assert_array_equal(
                np.concatenate([r["local"][key] for r in ranks]),
                params[key])
        assert ranks[0]["local"]["item_emb"].shape[0] < \
            ranks[1]["local"]["item_emb"].shape[0]
    else:
        assert [r["tp"] for r in ranks] == [True] * 4
        for key in ("user_emb", "item_emb"):
            np.testing.assert_array_equal(
                np.concatenate([ranks[0]["local"][key],
                                ranks[1]["local"][key]]), params[key])
            np.testing.assert_array_equal(ranks[0]["local"][key],
                                          ranks[2]["local"][key])
        for r in ranks:
            np.testing.assert_array_equal(r["local"]["item_bias"],
                                          params["item_bias"])


def test_predict_topk_equals_the_full_topk(fitted):
    for r in fitted["ranks"]:
        vals, ids, ref_v, ref_i = r["topk"]
        np.testing.assert_allclose(vals, ref_v, rtol=1e-6, atol=1e-6)
        finite = np.isfinite(ref_v)
        np.testing.assert_array_equal(ids[finite], ref_i[finite])


def test_topk_evaluation_equals_full(fitted):
    for r in fitted["ranks"]:
        assert r["topk_report"].keys() == r["full_report"].keys()
        np.testing.assert_allclose(list(r["topk_report"].values()),
                                   list(r["full_report"].values()),
                                   rtol=0, atol=1e-7)


def test_checkpoints_hold_whole_tables_and_resume_rows(fitted):
    """Rank 0's checkpoint equals the single device's (parameters and Adam
    moments, gathered whole); a resumed model takes back each rank's rows
    and moments."""
    got = torch.load(sorted(glob.glob(os.path.join(
        fitted["work"], "ckpt", fitted["name"], "step_*.pt")))[-1])
    ref = torch.load(sorted(glob.glob(os.path.join(
        fitted["work"], "single", fitted["name"], "step_*.pt")))[-1])
    assert got["params"].keys() == ref["params"].keys()
    for key in ref["params"]:
        np.testing.assert_allclose(got["params"][key].numpy(),
                                   ref["params"][key].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    for i, st in ref["optimizer"]["state"].items():
        assert got["optimizer"]["state"][i]["exp_avg"].shape == \
            st["exp_avg"].shape
        np.testing.assert_allclose(
            got["optimizer"]["state"][i]["exp_avg"].numpy(),
            st["exp_avg"].numpy(), rtol=1e-4, atol=1e-6)
    for r in fitted["ranks"]:
        for key, value in r["local"].items():
            np.testing.assert_array_equal(r["resumed"][key], value)
        for a, b in zip(r["resumed_moments"], r["moments"]):
            np.testing.assert_array_equal(a, b)


def test_refusals_under_a_mesh(fitted, data, tmp_path, monkeypatch):
    """Every model builds under a mesh, which needs the ranks' process
    group: Pop under mesh_shape (1, 2) in one process raises for the
    missing ranks, not for the model. BPRMF's lazy Adam builds on every
    rank with its tables whole (no tensor parallelism)."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="does not match 1 ranks"):
        _model("Pop", data[1], {}, mesh_shape=(1, 2))
    if fitted["name"] == "BPRMF":
        for r in fitted["ranks"]:
            tp, blocks, shape, whole = r["lazy"]
            assert (tp, blocks, shape) == (False, {}, whole)


def test_command_line_on_two_ranks_writes_one_log(data, tmp_path):
    """run_skrx_torch.main with --mesh_shape "(1,2)" on 2 ranks: both
    return the single-device command's report, and one log is written,
    rank 0's."""
    import run_skrx_torch
    root, path = data
    argv = ["--recommender", "LightGCN", "--data_dir", path, "--epochs",
            "1", "--early_stop", "1", "--embed_size", "8", "--batch_size",
            "128", "--top_k", "(5,10)", "--test_batch_size", "16"]
    single, mesh = tmp_path / "single", tmp_path / "mesh"
    single.mkdir()
    mesh.mkdir()
    cwd = os.getcwd()
    os.chdir(single)
    try:
        ref = dict(run_skrx_torch.main(argv, device="cpu").results)
    finally:
        os.chdir(cwd)
    got = run_ranks(_main_rank, 2, (argv + ["--mesh_shape", "(1,2)"],
                                    str(mesh)), timeout=300)
    for r in got:
        np.testing.assert_allclose(list(r.values()), list(ref.values()),
                                   rtol=0, atol=1e-6)
    name = os.path.basename(os.path.normpath(path))
    logs = glob.glob(str(mesh / "log" / "*" / "*" / "*.log"))
    assert [os.path.dirname(f) for f in logs] == [
        str(mesh / "log" / name / "LightGCN")]
