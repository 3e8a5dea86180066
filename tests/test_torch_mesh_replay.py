"""One model of each mesh mechanism on a (2, 2) mesh of 4 gloo ranks on
the CPU against the JAX package's single-device fit() at the same seed:
the port starts from JAX's initial weights and trains on JAX's global
batches (captured from JAX's jitted epochs, each rank slicing its data
index's rows), so its metrics and its parameters, gathered whole, must be
JAX's. The cases:

* LayerGCN, its sharded static graph through kernel #11 under JAX's
  per-epoch pruning (an edge mask over the original edge ids);
* SLMRec, the in-batch softmax over the batch gathered over the data axis;
* SASRec, replicated dense gradients summed over the data axis, then
  ``predict_topk`` through #1-#5;
* FPMC, tables split over the model axis, read through ``lookup_rows``;
* GRU4Rec, the walker's lanes split over the data axis with the whole
  batch's targets as negatives;
* BPRMF with lazy Adam, the whole batch's rows gathered for one update.

Each rank also saves a checkpoint every epoch and a model built again with
``resume=True`` takes back its rows and optimizer state. JAX is imported
only inside the tests; the ranks import none of it.
"""
import os

import numpy as np
import pytest
import torch

from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.models.LayerGCN import layergcn_mask_from_keep
from skrx_torch.ops.metrics import mask_items, topk_scores_and_indices
from skrx_torch.parallel import run_ranks

SHAPE = (2, 2)
EPOCHS = 2
RUN = dict(file_column="UIRT", sep="\t", metric=("Recall", "NDCG"),
           top_k=(5, 10), test_batch_size=16, seed=2021)
GRAPH = dict(lr=0.01, batch_size=128, epochs=EPOCHS, early_stop=EPOCHS)
CASES = {
    "LayerGCN": dict(embed_dim=8, n_layers=2, dropout=0.2, reg=0.001,
                     **GRAPH),
    "SLMRec": dict(rec_dim=8, layer_num=2, ssl_task="FAC", **GRAPH),
    "SASRec": dict(lr=0.01, hidden_units=8, max_len=10, num_blocks=1,
                   num_heads=1, dropout_rate=0.0, batch_size=16,
                   epochs=EPOCHS, early_stop=EPOCHS),
    "FPMC": dict(lr=0.05, reg=0.01, embed_size=8, batch_size=128,
                 epochs=EPOCHS, early_stop=EPOCHS),
    "GRU4Rec": dict(lr=0.001, layers=[8], batch_size=16, epochs=EPOCHS,
                    early_stop=EPOCHS),
    "BPRMF": dict(lr=0.05, reg=0.001, n_dim=8, batch_size=128,
                  optimizer="lazy_adam", epochs=EPOCHS, early_stop=EPOCHS),
}
# NDCG of LayerGCN under pruning: JAX's single device rebuilds the pruned
# edge lists, the mesh propagates the static graph under a mask (JAX's own
# mesh test holds the two to 2e-3)
METRIC_TOL = {"LayerGCN": dict(rtol=2e-3, atol=1e-5)}
# seeded random weights, in JAX and in the port alike, for two models:
# at SASRec's initial layer norms (scale 1, bias 0) the attention's query
# mask, sign(|sum(LN(x))|), reads a sum that is 0 but for rounding, so JAX
# and torch mask different positions; from GRU4Rec's initial weights rows
# of near-zero gradient take Adam's whole first steps on rounding
# differences (the port's single device ends 3e-4 of a table's scale from
# JAX's after two epochs; from these weights 6e-6)
RANDOM_WEIGHTS = ("SASRec", "GRU4Rec")
# as in test_torch_mesh_models: biases of exactly zero gradient that move
# only by rounding noise
NOISE_DRIVEN = {"SASRec": ("blocks.0.att.k.b",),
                "SLMRec": ("g_v_iv.b", "g_t_ivat.b")}


def _build(name, data, **run):
    reg = ModelRegistry()
    reg.load_skrx_model(name)
    return reg.get_model(name)[0](RunConfig(data_dir=data, **RUN, **run),
                                  dict(CASES[name]), device="cpu")


def _replay(m, name, replay):
    """JAX's initial weights, JAX's batches one a step (the pipeline slices
    them) and LayerGCN's pruned pairs of each epoch."""
    m.load_jax_params(replay["params0"])
    if replay["batches"] is not None:
        steps = iter(replay["batches"])
        m.pipeline._batch = lambda generator, idx: tuple(
            torch.tensor(a) for a in next(steps))
    if name == "LayerGCN":
        m.epoch_mask = lambda epoch: layergcn_mask_from_keep(
            torch.tensor(replay["keep"][epoch]), m._rows, m._cols, m._base,
            m.num_users, m.num_items)


def _rank(rank, data, work, replays):
    os.chdir(work)
    out = {}
    for name, replay in replays.items():
        ckpt = os.path.join(work, "ckpt")
        m = _build(name, data, mesh_shape=SHAPE, checkpoint_dir=ckpt,
                   checkpoint_every=1)
        _replay(m, name, replay)
        best = m.fit()
        got = {"best": dict(best.results),
               "params": {k: v.numpy() for k, v in m.full_params().items()},
               "local": {k: v.detach().numpy().copy()
                         for k, v in m.named_parameters()}}
        if name == "SASRec":
            users = np.arange(16)
            train = torch.as_tensor(
                m.evaluator._tables_for(users, m.num_items)[0])
            vals, ids = m.predict_topk(users, 10, train)
            ref_v, ref_i = topk_scores_and_indices(
                mask_items(m.predict(users), train), 10)
            got["topk"] = (vals.numpy(), ids.numpy(), ref_v.numpy(),
                           ref_i.numpy())
        again = _build(name, data, mesh_shape=SHAPE, checkpoint_dir=ckpt,
                       checkpoint_every=1, resume=True)
        again.fit()            # restores the last epoch, trains nothing
        got["resumed"] = {k: v.detach().numpy()
                          for k, v in again.named_parameters()}
        got["opt_equal"] = _same_state(m.optimizer.state_dict(),
                                       again.optimizer.state_dict())
        out[name] = got
    return out


def _same_state(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return bool(torch.equal(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_state(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same_state, a, b))
    return a == b


def _jax_fit(name, data, work):
    """JAX's single-device model at the seed: its initial weights, the
    batches its fit() draws (``_shard_batches`` hands each epoch's to the
    host), LayerGCN's pruned pair ids, and its fit()."""
    import jax
    import skrx.models.SASRec as jax_sasrec
    import skrx.models.pipeline as jax_pipeline
    from skrx import RunConfig as JaxRunConfig
    from skrx.utils import ModelRegistry as JaxRegistry

    epochs = []

    def spy(mesh, batch_data):
        # copies: the buffers may be donated and reused
        jax.debug.callback(lambda *a: epochs.append([np.array(x)
                                                     for x in a]),
                           *batch_data, ordered=True)
        return batch_data

    reg = JaxRegistry()
    reg.load_skrx_model(name)
    cwd = os.getcwd()
    os.chdir(work)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax_pipeline, "_shard_batches", spy)
        mp.setattr(jax_sasrec, "_shard_batches", spy)
        jm = reg.get_model(name)[0](
            JaxRunConfig(recommender=name, data_dir=data, **RUN),
            dict(CASES[name]))
        if name in RANDOM_WEIGHTS:
            rng = np.random.default_rng(3)
            jm.params = jax.tree_util.tree_map(
                lambda a: jax.numpy.asarray(
                    (rng.standard_normal(a.shape) * 0.3).astype(np.float32)),
                jm.params)
            jm.opt_state = jm.optimizer.init(jm.params)
        # copies: fit() donates the parameters' buffers
        params0 = jax.tree_util.tree_map(np.array, jm.params)
        keep = []
        if name == "LayerGCN":
            pairs = jm.dataset.train_data.to_user_item_pairs()
            pair_id = {(int(u), int(i)): e for e, (u, i) in
                       enumerate(pairs[:, :2])}
            edges = jm._epoch_edges

            def spy_edges(key, epoch):
                src, dst, w = out = edges(key, epoch)
                k = len(src) // 2
                keep.append(np.asarray(
                    [pair_id[(int(u), int(i) - jm.num_users)] for u, i in
                     zip(np.asarray(dst[:k]), np.asarray(src[:k]))]))
                return out
            mp.setattr(jm, "_epoch_edges", spy_edges)
        best = jm.fit()
        params = dict(_flat(jax.tree_util.tree_map(np.array, jm.params)))
    finally:
        mp.undo()
        os.chdir(cwd)
    batches = None
    if name != "GRU4Rec":
        assert len(epochs) == EPOCHS
        batches = []
        for arrays in epochs:
            if name == "SASRec":       # (seqs, poss, neg, w): no user ids
                arrays = [np.zeros(arrays[0].shape[:2], np.int64), *arrays]
            for step in range(arrays[0].shape[0]):
                batches.append(tuple(
                    a[step].astype(np.float32 if a.dtype.kind == "f"
                                   else np.int64) for a in arrays))
    return (dict(params0=params0, batches=batches, keep=keep),
            dict(best.results), params)


def _flat(tree, prefix=""):
    """(dotted path, leaf) of a nested dict / list of arrays."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pytest.importorskip("jax")
    from skrx.io import synthetic
    root = str(tmp_path_factory.mktemp("mesh_replay"))
    data = synthetic.make_dataset_dir(
        root, num_users=48, num_items=72, num_ratings=1300, seed=11,
        with_mm=True, img_dim=12, txt_dim=10, latent_dim=4,
        latent_strength=6.0)
    replays, ref = {}, {}
    for name in CASES:
        work = os.path.join(root, f"jax_{name}")
        os.makedirs(work)
        replays[name], best, params = _jax_fit(name, data, work)
        ref[name] = (best, params)
    work = os.path.join(root, "mesh")
    os.makedirs(work)
    ranks = run_ranks(_rank, SHAPE[0] * SHAPE[1], (data, work, replays),
                      timeout=600)
    return ref, ranks


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_replay_equals_jax_single_device(runs, name):
    """Every rank's best metrics and whole parameters equal JAX's
    single-device fit()."""
    ref, ranks = runs
    best, params = ref[name]
    for r in ranks:
        got = r[name]
        assert got["best"].keys() == best.keys()
        np.testing.assert_allclose(
            list(got["best"].values()), list(best.values()),
            **METRIC_TOL.get(name, dict(rtol=1e-5, atol=1e-7)),
            err_msg=name)
        # the port's parameter names are JAX's leaf paths, dotted
        port = got["params"]
        assert port.keys() == params.keys()
        for key, want in params.items():
            if key in NOISE_DRIVEN.get(name, ()):
                continue
            scale = max(float(np.abs(want).max()), 1e-30)
            np.testing.assert_allclose(port[key], want, rtol=0,
                                       atol=1e-5 * scale,
                                       err_msg=f"{name} {key}")


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_checkpoint_resumes_each_ranks_rows(runs, name):
    """A model built again with resume=True takes back each rank's rows of
    the whole tables its checkpoint holds, and the optimizer's state."""
    for r in runs[1]:
        got = r[name]
        for key, value in got["local"].items():
            np.testing.assert_array_equal(got["resumed"][key], value,
                                          err_msg=f"{name} {key}")
        assert got["opt_equal"], name


def test_sasrec_predict_topk_on_the_replayed_model(runs):
    for r in runs[1]:
        vals, ids, ref_v, ref_i = r["SASRec"]["topk"]
        np.testing.assert_allclose(vals, ref_v, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(ids, ref_i)
