"""SGAT in the port against the JAX package's, on the same data, weights,
Adam state and batch. The graph's six arrays equal ``_build_sgat_graph``'s
(repeated (tail, head, user) steps, a user of one item) and both packages
read one cache file. One train step (JAX's flat Adam state converted)
against JAX's ``graph_impl="segment"`` at three layers, on a dataset whose
``mexp`` minimum is tied (one user repeating a step; a user whose
embedding is zero stepping from an item to itself, where ``l2d``'s
gradient must stay finite) and with bf16 messages, and once against
``"mxu"`` in interpret mode: the loss and every parameter within rtol
1e-5 / atol 1e-6. predict within rtol 1e-5, evaluate() within 1e-6 of
JAX's, the chunked route equal to the full one, no fused route; config,
registry and fit() with checkpoint and resume."""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from skrx import RunConfig as JaxRunConfig
from skrx.io import synthetic as jax_synthetic
from skrx.models.SGAT import SGAT as JaxSGAT
from skrx.models.SGAT import SGATConfig as JaxSGATConfig
from skrx.models.SGAT import _build_sgat_graph
from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.models.SGAT import (SGAT, SGATConfig, build_sgat_graph,
                                    l2d)
from skrx_torch.models.pipeline import epoch_generator

DIM = 8
TOL = dict(rtol=1e-5, atol=1e-6)
RUN = dict(seed=1, metric=("NDCG", "Recall"), top_k=(5, 10),
           test_batch_size=16)
CFG = dict(embed_size=DIM, n_layers=3, n_seqs=3, n_next=2, lr=0.01,
           reg=0.01, batch_size=16)
KEYS = ("item_bias", "item_emb", "user_emb")
TIED_USER, SELF_USER, FAR = 0, 1, 3.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_tied_data(root: str) -> str:
    """A dataset of 8 users x 14 items: user 0 steps 1 -> 2 twice, user 1
    steps 4 -> 4, user 7 has no training rows."""
    rng = np.random.default_rng(2)
    seqs = {0: [1, 2, 1, 2, 3], 1: [4, 4, 6, 8]}
    for u in range(2, 7):
        seqs[u] = list(rng.choice(np.arange(3, 14), 7, replace=False))
    train = [(u, i, 1, t) for u, s in seqs.items() for t, i in enumerate(s)]
    test = [(u, int(i), 1, 99) for u, i in
            zip(range(8), rng.integers(0, 14, 8))]
    name = "tied"
    out = os.path.join(root, name)
    os.makedirs(out, exist_ok=True)
    for suffix, rows in ((".train", train), (".test", test)):
        np.savetxt(os.path.join(out, name + suffix), np.array(rows),
                   fmt="%d", delimiter="\t")
    return out


@pytest.fixture(scope="module")
def build(tmp_path_factory):
    """(jax model, port model) on the synthetic or the tied data."""
    root = tmp_path_factory.mktemp("torch_sgat")
    data = {"synthetic": jax_synthetic.make_dataset_dir(
        str(root), num_users=40, num_items=60, num_ratings=900, seed=14),
        "tied": _write_tied_data(str(root))}
    cache = {}

    def make(which="synthetic", **over):
        key = (which,) + tuple(sorted(over.items()))
        if key not in cache:
            cfg = dict(CFG, **over)
            jax_cfg = dict(cfg, graph_impl={"mxu_bf16": "mxu_bf16",
                                            "mxu": "mxu"}.get(
                cfg.get("graph_impl"), "segment"))
            cwd = os.getcwd()
            os.chdir(root)                 # the models write log/ here
            try:
                jm = JaxSGAT(JaxRunConfig(recommender="SGAT",
                                          data_dir=data[which], **RUN),
                             jax_cfg)
                tm = SGAT(RunConfig(data_dir=data[which], **RUN), cfg,
                          device="cpu")
            finally:
                os.chdir(cwd)
            cache[key] = (jm, tm)
        return cache[key]
    return make


def _set_weights(jm, tm, rng, scale=0.3):
    params = {"user_emb": rng.standard_normal((jm.num_users, DIM)),
              "item_emb": rng.standard_normal((jm.num_items, DIM)),
              "item_bias": rng.standard_normal(jm.num_items)}
    params = {k: (v * scale).astype(np.float32) for k, v in params.items()}
    jm.params = {k: jnp.asarray(v) for k, v in params.items()}
    jm._final_items = None
    tm.load_jax_params(params)
    return params


def test_graph_arrays_and_cache_match_jax(build):
    jm, tm = build()
    user_pos = jm.dataset.train_data.to_user_dict_by_time()
    got = build_sgat_graph(user_pos)
    ref = _build_sgat_graph(user_pos, jm.num_items)
    jt, tt = build("tied")
    tied = jt.dataset.train_data.to_user_dict_by_time()
    for a, b in zip(got + build_sgat_graph(tied),
                    ref + _build_sgat_graph(tied, jt.num_items)):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    occ_edge = ref[3]
    assert len(occ_edge) > len(ref[4])               # repeated steps
    single = {0: np.array([3], np.int32), 2: np.array([5, 5], np.int32)}
    for a, b in zip(build_sgat_graph(single), _build_sgat_graph(single, 9)):
        np.testing.assert_array_equal(a, b)
    # the model's graph: JAX's cache file, edges src = head, dst = tail
    g = tt.graph
    path = os.path.join(os.path.dirname(jt.dataset.data_dir), "_sgat_data",
                        "tied", "graph_elem.npz")
    with np.load(path) as blob:
        arrays = {k: blob[k] for k in blob.files}
    want = _build_sgat_graph(tied, jt.num_items)
    for k, a in zip(("occ_user", "occ_head", "occ_tail", "occ_edge",
                     "edge_tail", "edge_head"), want):
        np.testing.assert_array_equal(arrays[k], a)
    np.testing.assert_array_equal(g.occ_user.numpy(), want[0])
    np.testing.assert_array_equal(g.items.src.numpy(), want[5])
    np.testing.assert_array_equal(g.items.dst.numpy(), want[4])
    np.testing.assert_array_equal(g.occ_edge.numpy(), want[3])


def _tie(params, jm):
    """Weights under which the largest distance of layer 1 is user 0's
    repeated step 1 -> 2 (twice), and user 1's step 4 -> 4 has distance 0."""
    far = np.zeros(DIM, np.float32)
    far[0] = FAR
    params["item_emb"][1] = 0.0
    params["item_emb"][2] = far
    params["user_emb"][TIED_USER] = -0.5 * far
    params["user_emb"][SELF_USER] = 0.0
    jm.params = {k: jnp.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("case", ["segment", "tied", "tied_bf16", "mxu"])
def test_train_step_matches_jax(build, case):
    from jax.flatten_util import ravel_pytree
    which = "synthetic" if case in ("segment", "mxu") else "tied"
    over = {"mxu": dict(graph_impl="mxu", n_layers=1),
            "tied_bf16": dict(graph_impl="mxu_bf16")}.get(case, {})
    jm, tm = build(which, **over)
    rng = np.random.default_rng(7)
    params = _set_weights(jm, tm, rng)
    if which == "tied":
        _tie(params, jm)
        tm.load_jax_params(params)
        g = tm.graph
        h_e = (tm.item_emb[g.occ_head] + tm.user_emb[g.occ_user]).detach()
        logit = -l2d(h_e, tm.item_emb.detach()[g.occ_tail])
        assert int((logit == logit.min()).sum()) == 2          # tied
        assert float(logit.max()) == -float(torch.sqrt(torch.tensor(1e-12)))
    flat, unravel = ravel_pytree(jm.params)
    mu = rng.standard_normal(flat.shape[0]).astype(np.float32) * 0.05
    nu = rng.uniform(1e-3, 1e-2, flat.shape[0]).astype(np.float32)
    adam, *rest = jm.optimizer.init(flat)
    carry = (flat, (adam._replace(count=jnp.asarray(3, jnp.int32),
                                  mu=jnp.asarray(mu), nu=jnp.asarray(nu)),
                    *rest))
    tm.load_jax_opt_state(3, mu, nu)
    batch = next(tm.pipeline.batches(epoch_generator(3, 0,
                                                     torch.device("cpu"))))
    assert batch[1].shape == (16, 2) and batch[4].shape == (16, 3)
    if which == "synthetic":
        assert (batch[4] == jm.num_items).any()              # pre-padded
    jbatch = tuple(jnp.asarray(x.numpy().astype(
        np.float32 if x.dtype == torch.float32 else np.int32)) for x in batch)
    carry, ref_loss = jax.jit(jm._train_step)(carry, jbatch)
    loss = tm.train_step(batch)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    ref = unravel(carry[0])
    for key in KEYS:
        got = getattr(tm, key).detach().numpy()
        assert np.isfinite(got).all(), key
        np.testing.assert_allclose(got, np.asarray(ref[key]), **TOL,
                                   err_msg=key)


def test_predict_and_evaluate_match_jax(build):
    jm, tm = build()
    _set_weights(jm, tm, np.random.default_rng(5), scale=1.0)
    users = np.arange(jm.num_users)
    np.testing.assert_allclose(tm.predict(users).numpy(),
                               np.asarray(jm.predict(users)), **TOL)
    frozen = tm._final_emb
    assert frozen is not None and tm.predict(users[:3]) is not None \
        and tm._final_emb is frozen                   # propagated once
    np.testing.assert_array_equal(tm.test_seqs.numpy(),
                                  np.asarray(jm._test_seqs))
    uv = tm._cached_user_vectors(users[:9])
    np.testing.assert_allclose(uv.numpy(),
                               np.asarray(jm._user_vectors(users[:9])), **TOL)
    np.testing.assert_allclose(
        tm._topk_score_fn(*tm._topk_factors(uv)).detach().numpy(),
        tm.predict(users[:9]).numpy(), rtol=1e-5, atol=1e-5)
    ref, got = jm.evaluate(), tm.evaluate()
    assert tm._final_emb is not frozen                # evaluate() froze anew
    assert list(got.metrics()) == list(ref.metrics())
    np.testing.assert_allclose(list(got.values()), list(ref.values()),
                               rtol=0, atol=1e-6)
    ev = tm.evaluator
    ev.eval_mode, ev.chunk_size = "chunked", 16
    try:
        np.testing.assert_allclose(list(tm.evaluate().values()),
                                   list(got.values()), rtol=0, atol=1e-6)
        ev.eval_mode = "fused"
        with pytest.raises(TypeError, match="fused"):
            tm.evaluate()
    finally:
        ev.eval_mode = "full"
    jt, tt = build("tied")                 # user 7: no training rows
    assert (tt.test_seqs[7] == tt.num_items).all()
    np.testing.assert_array_equal(tt.test_seqs.numpy(),
                                  np.asarray(jt._test_seqs))


def test_config_registry_and_fit(build, tmp_path, monkeypatch):
    _, tm = build()
    reg = ModelRegistry()
    reg.load_skrx_model("SGAT")
    assert reg.get_model("SGAT") == (SGAT, SGATConfig)
    defaults, ref = SGATConfig(), JaxSGATConfig()
    for field in defaults.to_dict():
        assert getattr(defaults, field) == getattr(ref, field), field
    for bad in (dict(graph_impl="dense"), dict(n_seqs=0), dict(n_next=0),
                dict(n_layers=-1), dict(lr=1)):
        with pytest.raises(ValueError):
            SGATConfig(**bad)
    monkeypatch.chdir(tmp_path)
    run = dict(data_dir=tm.dataset.data_dir, seed=1, top_k=(10,),
               checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1)
    cfg = dict(CFG, n_layers=2, batch_size=128)
    m = SGAT(RunConfig(**run), dict(cfg, epochs=2), device="cpu")
    m.fit()
    losses = [h["loss"] for h in m.history]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert m._final_emb is not None          # the last evaluation's table
    resumed = SGAT(RunConfig(**run, resume=True), dict(cfg, epochs=3),
                   device="cpu")
    state = {}
    first = resumed._train_epoch

    def snapshot(epoch):
        state.update({k: v.detach().clone()
                      for k, v in resumed.named_parameters()})
        return first(epoch)
    resumed._train_epoch = snapshot
    resumed.fit()
    assert [h["epoch"] for h in resumed.history] == [2]
    for name, value in m.named_parameters():
        assert torch.equal(state[name], value.detach()), name
