"""SASRec and BERT4Rec in the port against the JAX package's, on the same
data, weights and optimizer state. The training rows, windows and test
tokens equal to JAX's. One training step (JAX's epoch of one batch) with
JAX's permutation, negatives, dropout masks and MLM uniforms, rebuilt from
its keys, handed to the port's loss: the loss and every parameter after
the update within rtol 1e-5 / atol 1e-6 in f32 (BERT4Rec's Adam state at
count 50, so that the warm-up's learning rate is above 0), within 2e-2
relative (loss) and 2e-3 of each parameter's scale in bf16 (the encoder on
bf16 copies: the two libraries round bf16 products and reductions
differently). BERT4Rec's clip, schedule and AdamW against optax's chain
over 3 updates, the first at lr 0, the second clipped. tanh GELU. predict
within rtol 1e-5, evaluate() within 1e-6 of JAX's on the full, fused and
chunked routes; config checks, the registry and the converters."""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from skrx import RunConfig as JaxRunConfig
from skrx.models.BERT4Rec import BERT4Rec as JaxBERT4Rec
from skrx.models.BERT4Rec import BERT4RecConfig as JaxBERT4RecConfig
from skrx.models.SASRec import SASRec as JaxSASRec
from skrx.models.SASRec import SASRecConfig as JaxSASRecConfig
from skrx.ops.sampling import sample_negatives as jax_sample_negatives
from skrx.serve import TopKRecommender as JaxTopK
from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.convert import (bert4rec_params_from_jax,
                                sasrec_params_from_jax)
from skrx_torch.models.BERT4Rec import BERT4Rec, BERT4RecConfig
from skrx_torch.models.SASRec import SASRec, SASRecConfig
from skrx_torch.serve import TopKRecommender

TOL = dict(rtol=1e-5, atol=1e-6)
RUN = dict(seed=1, metric=("NDCG", "Recall"), top_k=(5, 10),
           test_batch_size=16)
MODELS = {"SASRec": (JaxSASRec, SASRec, JaxSASRecConfig, SASRecConfig,
                     sasrec_params_from_jax,
                     dict(hidden_units=8, max_len=6, num_blocks=2,
                          num_heads=2, batch_size=32, lr=0.01,
                          l2_emb=0.01)),
          "BERT4Rec": (JaxBERT4Rec, BERT4Rec, JaxBERT4RecConfig,
                       BERT4RecConfig, bert4rec_params_from_jax,
                       dict(h_size=8, att_heads=2, n_layers=2, max_seq_len=4,
                            batch_size=128, lr=0.01, epochs=2))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_data(root: str) -> str:
    """20 users x 30 items in time order, 1..12 training items a user
    (user 4 holds one), 1 or 2 test items (users with two see the first in
    BERT4Rec's test row)."""
    rng = np.random.default_rng(6)
    train, test = [], []
    for u in range(20):
        n = 1 if u == 4 else int(rng.integers(2, 13))
        items = rng.permutation(30)
        train += [(u, int(i), 1, t) for t, i in enumerate(items[:n])]
        test += [(u, int(i), 1, 50 + t)
                 for t, i in enumerate(items[n:n + 1 + u % 2])]
    name = "seqtower"
    out = os.path.join(root, name)
    os.makedirs(out, exist_ok=True)
    for suffix, rows in ((".train", train), (".test", test)):
        np.savetxt(os.path.join(out, name + suffix), np.array(rows),
                   fmt="%d", delimiter="\t")
    return out


@pytest.fixture(scope="module")
def build(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_sasrec_bert4rec")
    data = _write_data(str(root))
    cache = {}

    def make(name, **over):
        key = (name,) + tuple(sorted(over.items()))
        if key not in cache:
            jcls, tcls, *_, small = MODELS[name]
            cfg = dict(small, **over)
            cwd = os.getcwd()
            os.chdir(root)
            try:
                jm = jcls(JaxRunConfig(recommender=name, data_dir=data,
                                       **RUN), dict(cfg))
                tm = tcls(RunConfig(data_dir=data, **RUN), dict(cfg),
                          device="cpu")
            finally:
                os.chdir(cwd)
            cache[key] = (jm, tm)
        return cache[key]
    return make


def _set_weights(jm, tm, rng, scale=0.3):
    params = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, jm.params))
    jm.params = jax.tree_util.tree_map(jnp.asarray, params)
    tm.load_jax_params(params)
    return params


def _bern(key, rate, shape):
    return torch.from_numpy(np.array(jax.random.bernoulli(key, 1.0 - rate,
                                                          shape)))


def _sasrec_step_inputs(jm, epoch):
    """The batch and dropout masks of the one step of JAX's epoch."""
    cfg = jm.config
    key = jax.random.fold_in(jm._rng, epoch)
    k_perm, k_neg, k_steps = jax.random.split(key, 3)
    perm = jax.random.permutation(k_perm, jm._users.shape[0])
    users, seqs, poss, w = (x[perm] for x in (jm._users, jm._seqs, jm._poss,
                                              jm._w))
    neg = jax_sample_negatives(k_neg, users, jm._pos_table, jm.num_items,
                               num_neg=cfg.max_len, num_trials=8)
    neg = jnp.where(poss != jm.num_items, neg, jm.num_items)
    _, sub = jax.random.split(k_steps)
    b, big_l, d, h = users.shape[0], cfg.max_len, cfg.hidden_units, \
        cfg.num_heads
    rate = cfg.dropout_rate
    rng, emb_key = jax.random.split(sub)
    blocks = []
    for _ in range(cfg.num_blocks):
        rng, k1, k2 = jax.random.split(rng, 3)
        f1, f2 = jax.random.split(k2)
        blocks.append((_bern(k1, rate, (b, h, big_l, big_l)),
                       (_bern(f1, rate, (b, big_l, d)),
                        _bern(f2, rate, (b, big_l, d)))))
    draws = (_bern(emb_key, rate, (b, big_l, d)), blocks)
    batch = tuple(torch.from_numpy(np.asarray(x).astype(
        np.float32 if x.dtype == jnp.float32 else np.int64))
        for x in (users, seqs, poss, neg, w))
    return batch, draws


def _bert_step_inputs(jm, epoch):
    cfg = jm.config
    key = jax.random.fold_in(jm._rng, epoch)
    k_perm, k_steps = jax.random.split(key)
    perm = jax.random.permutation(k_perm, jm._windows.shape[0])
    tokens, w = jm._windows[perm], jm._w[perm]
    _, sub = jax.random.split(k_steps)
    _, k_mask, k_enc = jax.random.split(sub, 3)
    b, big_l, d, h = tokens.shape[0], cfg.max_seq_len, cfg.h_size, \
        cfg.att_heads
    scores = torch.from_numpy(np.array(jax.random.uniform(k_mask,
                                                          tokens.shape)))
    rng, emb_key = jax.random.split(k_enc)
    blocks = []
    for _ in range(cfg.n_layers):
        rng, k1, k2, k3 = jax.random.split(rng, 4)
        blocks.append((_bern(k1, cfg.att_drop, (b, h, big_l, big_l)),
                       _bern(k2, cfg.h_drop, (b, big_l, d)),
                       _bern(k3, cfg.h_drop, (b, big_l, d))))
    draws = (scores, _bern(emb_key, cfg.h_drop, (b, big_l, d)), blocks)
    batch = (torch.from_numpy(np.asarray(tokens).astype(np.int64)),
             torch.from_numpy(np.asarray(w)))
    return batch, draws


def _adam_state(jm, rng, count):
    """JAX's opt_state with random moments and every count at ``count``,
    and (count, mu, nu) raveled in JAX's order."""
    from jax.flatten_util import ravel_pytree
    flat, unravel = ravel_pytree(jm.params)
    mu = rng.standard_normal(flat.shape[0]).astype(np.float32) * 0.05
    nu = rng.uniform(1e-3, 1e-2, flat.shape[0]).astype(np.float32)
    def c():         # a buffer of its own for each count (donated)
        return jnp.asarray(count, jnp.int32)

    def fill(s):
        if not hasattr(s, "_fields"):           # a chain's tuple
            return tuple(fill(x) for x in s)
        if "mu" in s._fields:
            return s._replace(count=c(), mu=unravel(mu), nu=unravel(nu))
        if "count" in s._fields:
            return s._replace(count=c())
        return s
    return fill(jm.opt_state), (count, mu, nu)


def _run_jax_epoch(name, jm, opt_state, epoch):
    if name == "SASRec":
        key = jax.random.fold_in(jm._rng, epoch)
        return jm._run_epoch(key, jm.params, opt_state, jm._users, jm._seqs,
                             jm._poss, jm._w, jm._pos_table)
    key = jax.random.fold_in(jm._rng, epoch)
    return jm._run_epoch(jm.params, opt_state, jm._windows, jm._w, key)


@pytest.mark.parametrize("name,dtype", [("SASRec", "float32"),
                                        ("SASRec", "bfloat16"),
                                        ("BERT4Rec", "float32"),
                                        ("BERT4Rec", "bfloat16")])
def test_train_step_matches_jax(build, name, dtype):
    # bf16 on one block (layer): the f32 cases hold the stacking
    one = dict(num_blocks=1) if name == "SASRec" else dict(n_layers=1)
    jm, tm = build(name, compute_dtype=dtype,
                   **(one if dtype == "bfloat16" else {}))
    convert = MODELS[name][4]
    rng = np.random.default_rng(11)
    params = _set_weights(jm, tm, rng)
    opt_state, flat_state = _adam_state(jm, rng,
                                        3 if name == "SASRec" else 50)
    tm.load_jax_opt_state(*flat_state)
    epoch = 1
    inputs = (_sasrec_step_inputs if name == "SASRec"
              else _bert_step_inputs)(jm, epoch)
    assert tm.pipeline.num_batches == 1
    p, jm.opt_state, ref_loss = _run_jax_epoch(name, jm, opt_state, epoch)
    jm.params = p                          # the epoch donates its inputs
    batch, draws = inputs
    loss = float(tm.train_step((*batch, draws)))
    f32 = dtype == "float32"
    np.testing.assert_allclose(loss, float(ref_loss),
                               rtol=1e-5 if f32 else 2e-2)
    ref = convert(jax.tree_util.tree_map(np.asarray, p))
    start = convert(params)
    got = dict(tm.named_parameters())
    assert set(got) == set(ref)
    for key, value in ref.items():
        want = value.numpy()
        if f32:
            np.testing.assert_allclose(got[key].detach().numpy(), want,
                                       **TOL, err_msg=key)
        else:
            scale = float(np.abs(want).max())
            np.testing.assert_allclose(got[key].detach().numpy(), want,
                                       rtol=0, atol=2e-3 * scale,
                                       err_msg=key)
        if name == "SASRec" or key != "tok_emb":
            assert not np.array_equal(want, start[key].numpy()), key


def test_training_rows_windows_and_test_tokens_match_jax(build):
    jm, tm = build("SASRec")
    seqs, poss = tm.pipeline._rows[1], tm.pipeline._rows[2]
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(jm._seqs))
    np.testing.assert_array_equal(poss.numpy(), np.asarray(jm._poss))
    np.testing.assert_array_equal(tm.pipeline._users.numpy(),
                                  np.asarray(jm._users))
    np.testing.assert_array_equal(tm.pipeline._w.numpy(), np.asarray(jm._w))
    np.testing.assert_array_equal(tm.test_seqs.numpy(),
                                  np.asarray(jm._test_seqs))
    jb, tb = build("BERT4Rec")
    np.testing.assert_array_equal(tb.pipeline._users.numpy(),
                                  np.asarray(jb._windows))
    np.testing.assert_array_equal(tb.pipeline._w.numpy(), np.asarray(jb._w))
    np.testing.assert_array_equal(tb.test_tokens.numpy(),
                                  np.asarray(jb._test_tokens))
    np.testing.assert_array_equal(tb.test_mask_pos.numpy(),
                                  np.asarray(jb._test_mask_pos))
    # users with two test items see the first before the mask
    two = [u for u, t in jb.dataset.test_data.to_user_dict().items()
           if len(t) == 2]
    assert two and all(int(tb.test_tokens[u, tb.test_mask_pos[u] - 1])
                       in jb.dataset.test_data.to_user_dict()[u]
                       for u in two if tb.test_mask_pos[u] > 0)


def test_bert4rec_optimizer_matches_optax_over_three_updates(build):
    """optax's chain on random gradients, the second far above the clip's
    norm of 5: the first update at lr 0 leaves the parameters (the moments
    move), the second is clipped, the third is not."""
    jm, tm = build("BERT4Rec")
    rng = np.random.default_rng(13)
    params = _set_weights(jm, tm, rng)
    jp = jm.params
    state = jm.optimizer.init(jp)
    tm.optimizer.count = 0
    for p in tm.parameters():
        tm.optimizer.state[p] = {"exp_avg": torch.zeros_like(p),
                                 "exp_avg_sq": torch.zeros_like(p)}
    named = dict(tm.named_parameters())
    update = jax.jit(jm.optimizer.update)
    for step, scale in enumerate((0.1, 50.0, 0.01)):
        grads = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape) * scale).astype(
                np.float32), params)
        updates, state = update(
            jax.tree_util.tree_map(jnp.asarray, grads), state, jp)
        jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, updates)
        for key, g in bert4rec_params_from_jax(grads).items():
            named[key].grad = g.clone()
        tm.optimizer.step()
        ref = bert4rec_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              jp))
        for key, value in ref.items():
            np.testing.assert_allclose(named[key].detach().numpy(),
                                       value.numpy(), **TOL,
                                       err_msg=f"{key} after {step + 1}")
        if step == 0:
            for key, value in bert4rec_params_from_jax(params).items():
                np.testing.assert_array_equal(named[key].detach().numpy(),
                                              value.numpy())
    assert tm.optimizer.count == 3
    decayed = {g["decay"]: {n for n, p in named.items()
                            if any(p is q for q in g["params"])}
               for g in tm.optimizer.param_groups}
    assert "tok_emb" in decayed[True] and "blocks.0.q.w" in decayed[True]
    assert {"out_bias", "ln_e_s", "blocks.1.ln2_b", "mlm_dense.b"} \
        <= decayed[False]


def test_tanh_gelu_matches_jax():
    """``jax.nn.gelu`` is the tanh approximation; torch's default (erf)
    differs from it by up to ~5e-4 on [-6, 6]."""
    x = torch.linspace(-6, 6, 101)
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(F.gelu(x, approximate="tanh").numpy(), ref,
                               rtol=1e-6, atol=1e-6)
    assert np.abs(F.gelu(x).numpy() - ref).max() > 1e-4


@pytest.mark.parametrize("name", ["SASRec", "BERT4Rec"])
def test_predict_routes_and_recommend_match_jax(build, name):
    jm, tm = build(name)
    _set_weights(jm, tm, np.random.default_rng(5))
    users = np.arange(tm.num_users)
    np.testing.assert_allclose(tm.predict(users).numpy(),
                               np.asarray(jm.predict(users)), **TOL)
    uv = tm._cached_user_vectors(users)
    np.testing.assert_allclose(uv.numpy(),
                               np.asarray(jm._user_vectors(users)), **TOL)
    ref_f = jm._topk_factors(jm._user_vectors(users))
    for got, want in zip(tm._topk_factors(uv), ref_f):
        if want is None:
            assert got is None
        else:
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), **TOL)
    ref, got = jm.evaluate(), tm.evaluate()
    assert list(got.metrics()) == list(ref.metrics())
    np.testing.assert_allclose(list(got.values()), list(ref.values()),
                               rtol=0, atol=1e-6)
    ev = tm.evaluator
    for mode in ("fused", "chunked"):
        ev.eval_mode, ev.chunk_size = mode, 16
        try:
            np.testing.assert_allclose(list(tm.evaluate().values()),
                                       list(got.values()), rtol=0, atol=1e-6)
        finally:
            ev.eval_mode = "full"
    ids, vals = TopKRecommender(tm, k=6).recommend(users)
    ref_ids, ref_vals = JaxTopK(jm, k=6).recommend(users)
    np.testing.assert_array_equal(ids, np.asarray(ref_ids))
    np.testing.assert_allclose(vals, np.asarray(ref_vals), **TOL)


@pytest.mark.parametrize("name", ["SASRec", "BERT4Rec"])
def test_config_registry_converter_and_fit(build, name, tmp_path,
                                           monkeypatch):
    jm, tm = build(name)
    _, cls, jcfg_cls, cfg_cls, convert, small = MODELS[name]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(RunConfig(data_dir=tm.dataset.data_dir), dict(small))
    reg = ModelRegistry()
    reg.load_skrx_model(name)
    assert reg.get_model(name) == (cls, cfg_cls)
    defaults, ref = cfg_cls(), jcfg_cls()
    for field in defaults.to_dict():
        assert getattr(defaults, field) == getattr(ref, field), field
    for bad in (dict(lr=1), dict(batch_size=0), dict(compute_dtype="f16")):
        with pytest.raises(ValueError):
            cfg_cls(**bad)
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    with pytest.raises(ValueError):
        convert({k: v for k, v in params.items() if k != "pos_emb"})
    with pytest.raises(ValueError):
        convert(dict(params, blocks=params["blocks"][:1] + [{}]))
    monkeypatch.chdir(tmp_path)
    m = cls(RunConfig(data_dir=tm.dataset.data_dir, seed=1, top_k=(10,)),
            dict(small, epochs=2), device="cpu")
    m.fit()
    losses = [h["loss"] for h in m.history]
    assert len(losses) == 2 and all(np.isfinite(losses))
    if name == "BERT4Rec":       # verbose=10: only the last epoch evaluates
        assert ["report" in h for h in m.history] == [False, True]
