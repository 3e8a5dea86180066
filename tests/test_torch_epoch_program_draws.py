"""The epoch as one program for the models that draw inside their step:
SelfCF, BM3 and SLMRec (under its FAC task, which draws nothing, and
under FD+FM, which draws FD's masks and FM's tower pair) on the
interaction pipeline, CDAE and MultVAE on the user-row pipeline. Their
per-leaf dense-Adam step (``LeafTrainStep``) against the JAX package's
per-leaf step with optax Adam over three batches under JAX's own draws
(rtol 1e-5 / atol 1e-6, ``tests/test_torch_selfcf.py``'s tolerances;
MultVAE's anneal count carried through); the captured route's step body
(``EpochProgram.step``, its draws from the program's step generator) run
eagerly against the eager epoch bit for bit, both generators' end states
too; a loaded checkpoint and JAX's Adam state copied into the tensors
the step holds; the captured route opted into by these five and the six
flat models only, and refused on the CPU. Widths of 8 on 1,500
synthetic ratings; the captured route itself (a CUDA graph) runs only on
a card, in the ``cuda`` test here and ``chip_smoke.py`` phases 11 and
14.

JAX is imported inside the tests that run it, so the card's test run,
which has no JAX, runs the rest of the file."""
import io

import numpy as np
import pytest
import torch

from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.io import synthetic
from skrx_torch.models.pipeline import epoch_generator

CPU = torch.device("cpu")
DIM = 8
# case -> (model, config); SLMRec's FD+FM case draws from the step
# generator, its default FAC does not
CASES = {
    "SelfCF": ("SelfCF", dict(embed_dim=DIM, n_layers=2, lr=0.01, reg=0.01,
                              batch_size=128)),
    "BM3": ("BM3", dict(embed_dim=DIM, n_layers=2, lr=0.01,
                        batch_size=128)),
    "SLMRec": ("SLMRec", dict(rec_dim=DIM, layer_num=2, lr=0.01,
                              ssl_alpha=0.5, batch_size=128)),
    "SLMRec-FD+FM": ("SLMRec", dict(rec_dim=DIM, layer_num=2, lr=0.01,
                                    ssl_alpha=0.5, ssl_task="FD+FM",
                                    batch_size=128)),
    "CDAE": ("CDAE", dict(hidden_dim=DIM, num_neg=2, lr=0.01,
                          batch_size=16)),
    "MultVAE": ("MultVAE", dict(p_dims=[DIM], lr=0.01, anneal_steps=40,
                                batch_size=16)),
}
# the models on the interaction pipeline, all three on kernel #11 (JAX's
# "segment" route)
INTERACTION = ("SelfCF", "BM3", "SLMRec")
# the models of earlier slices on the captured route (a flat step)
FLAT = {"BPRMF": dict(n_dim=DIM), "LightGCN": dict(embed_size=DIM,
                                                   n_layers=2),
        "FPMC": dict(embed_size=DIM), "TransRec": dict(embed_size=DIM),
        "SGAT": dict(embed_size=DIM, n_layers=2),
        "MGCN": dict(embed_dim=DIM, knn_k=5)}
# the models that stay on the eager route, each at a small width
EAGER = {"DENS": dict(dim=DIM, context_hops=2), "LightGCL": dict(d=DIM,
                                                                 svd_q=5),
         "LayerGCN": dict(embed_dim=DIM, n_layers=2),
         "FREEDOM": dict(embed_dim=DIM, feat_dim=DIM, knn_k=5),
         "LATTICE": dict(embed_dim=DIM, feat_embed_dim=DIM,
                         weight_size=[DIM, DIM], knn_k=5),
         "Caser": dict(embed_size=DIM), "HGN": dict(embed_size=DIM),
         "CML": dict(embed_size=DIM), "GRU4Rec": dict(layers=[DIM],
                                                      batch_size=32),
         "GRU4RecPlus": dict(layers=[DIM], batch_size=32, n_sample=16),
         "SASRec": dict(hidden_units=DIM, max_len=10, num_blocks=1),
         "BERT4Rec": dict(h_size=DIM, n_layers=1),
         "SRGNN": dict(hidden_size=DIM, max_seq_len=20)}
RUN = dict(seed=1, metric=("NDCG",), top_k=(10,), test_batch_size=32)
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """50 users, 80 items, 1,500 ratings (seed 9), with 12-d image and
    10-d text features."""
    root = str(tmp_path_factory.mktemp("torch_epoch_program_draws"))
    return root, synthetic.make_dataset_dir(
        root, num_users=50, num_items=80, num_ratings=1500, seed=9,
        with_mm=True, img_dim=12, txt_dim=10)


def _build(name, cfg, data, monkeypatch, device="cpu"):
    root, path = data
    monkeypatch.chdir(root)                # model construction writes log/
    reg = ModelRegistry()
    reg.load_skrx_model(name)
    return reg.get_model(name)[0](RunConfig(data_dir=path, **RUN),
                                  dict(cfg), device=device)


def _port(case, data, monkeypatch, device="cpu"):
    name, cfg = CASES[case]
    return _build(name, cfg, data, monkeypatch, device)


def _arrays(state) -> dict:
    """Every tensor of a nested training state, copied to the CPU, by
    path."""
    out = {}

    def walk(prefix, value):
        if isinstance(value, torch.Tensor):
            out[prefix] = value.detach().cpu().clone()
        elif isinstance(value, dict):
            for k, v in value.items():
                walk(f"{prefix}/{k}", v)
    walk("", state)
    return out


def _bits(state) -> dict:
    return {k: v.numpy().tobytes() for k, v in _arrays(state).items()}


def _saved(state: dict) -> dict:
    """A training state as a checkpoint holds it (saved and loaded: its
    tensors are the live ones until then)."""
    buf = io.BytesIO()
    torch.save(state, buf)
    buf.seek(0)
    return torch.load(buf)


def _jax(case):
    """The JAX side: jax, its ``RunConfig``, the JAX package's model class
    of ``case`` and the port's converter of its params."""
    jax = pytest.importorskip("jax")
    from skrx import RunConfig as JaxRunConfig
    from skrx.models.BM3 import BM3
    from skrx.models.CDAE import CDAE
    from skrx.models.MultVAE import MultVAE
    from skrx.models.SelfCF import SelfCF
    from skrx.models.SLMRec import SLMRec
    from skrx_torch import convert
    name = CASES[case][0]
    cls = {"SelfCF": SelfCF, "BM3": BM3, "SLMRec": SLMRec, "CDAE": CDAE,
           "MultVAE": MultVAE}[name]
    return jax, JaxRunConfig, cls, getattr(
        convert, f"{name.lower()}_params_from_jax")


def _jax_draws(case, jm, tm, key, users):
    """The port's draws of JAX's step with ``key`` (for ``users``), rebuilt
    as the models' own tests rebuild them."""
    import jax
    name = CASES[case][0]
    if name == "SelfCF":
        from tests.test_torch_selfcf import _jax_draws
        return _jax_draws(key, tm.graph.num_edges, len(users),
                          tm.config.dropout)[1]
    if name == "BM3":
        from tests.test_torch_bm3_slmrec import _bm3_jax_draws
        return _bm3_jax_draws(key, jm)
    if name == "SLMRec":
        from tests.test_torch_bm3_slmrec import _slmrec_jax_draws
        return _slmrec_jax_draws(key, tm.config, tm.num_users + tm.num_items)
    if name == "CDAE":
        from tests.test_torch_cdae import _jax_draws
        return _jax_draws(jm, tm, key, users, tm.config.dropout)
    k_drop, k_eps = jax.random.split(key)       # MultVAE
    keep = jax.random.bernoulli(k_drop, tm.config.keep_prob,
                                (len(users), tm.num_items))
    eps = jax.random.normal(k_eps, (len(users), tm.q_dims[-1]))
    return torch.from_numpy(np.array(keep)), torch.from_numpy(np.array(eps))


def _batches(case, jm, tm, rng, steps=3):
    """``steps`` batches, each (JAX's batch, its key, the port's batch
    with JAX's draws): interaction pairs with a repeated user and item
    and about 10% padded rows, or 16 users' rows with two padded."""
    import jax
    import jax.numpy as jnp
    out = []
    for i in range(steps):
        key = jax.random.key(30 + i)
        if CASES[case][0] in INTERACTION:
            b = 32
            users = rng.integers(0, tm.num_users, b)
            items = rng.integers(0, tm.num_items, b)
            users[1], items[3] = users[0], items[2]
            w = (rng.random(b) < 0.9).astype(np.float32)
            w[0] = 1.0
            jb = (jnp.asarray(users, jnp.int32), jnp.asarray(items, jnp.int32),
                  jnp.asarray(w))
            tb = (torch.from_numpy(users.astype(np.int64)),
                  torch.from_numpy(items.astype(np.int64)),
                  torch.from_numpy(w))
        else:
            users = rng.permutation(tm.num_users)[:16]
            w = np.ones(16, np.float32)
            w[-2:] = 0.0
            jb = (jnp.asarray(users, jnp.int32),
                  jm.pipeline.rows_for(jnp.asarray(users, jnp.int32)),
                  jnp.asarray(w))
            t_users = torch.from_numpy(users.astype(np.int64))
            tb = (t_users, tm.pipeline.rows_for(t_users), torch.from_numpy(w))
        out.append((jb, key, (*tb, _jax_draws(case, jm, tm, key, users))))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_leaf_step_matches_jax_leaf_step(case, data, monkeypatch):
    """The same weights and Adam state (count 3, JAX's moments converted)
    in both, then three batches through JAX's jitted per-leaf step (its
    draws from each batch's key) and the port's ``LeafTrainStep`` (given
    those draws): each step's loss, and after it every parameter and
    Adam's moments and count; MultVAE's anneal count carried from 7
    through the steps of both (anneal_steps 40: below the cap)."""
    jax, JaxRunConfig, jax_cls, convert = _jax(case)
    from jax.flatten_util import ravel_pytree
    import jax.numpy as jnp
    root, path = data
    name, cfg = CASES[case]
    monkeypatch.chdir(root)
    jm = jax_cls(JaxRunConfig(recommender=name, data_dir=path, **RUN),
                 dict(cfg, graph_impl="segment") if name in INTERACTION
                 else dict(cfg))
    tm = _port(case, data, monkeypatch)
    rng = np.random.default_rng(13)
    params = jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(np.shape(x)) * 0.3).astype(
            np.float32), jm.params)
    tm.load_jax_params(params)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    flat, unravel = ravel_pytree(params)
    mu = rng.standard_normal(flat.shape[0]).astype(np.float32) * 0.05
    nu = rng.uniform(1e-3, 1e-2, flat.shape[0]).astype(np.float32)
    adam, *rest = jm.optimizer.init(params)
    opt = (adam._replace(count=jnp.asarray(3, jnp.int32), mu=unravel(mu),
                         nu=unravel(nu)), *rest)
    tm.load_jax_opt_state(3, mu, nu)
    count = jnp.asarray(7.0, jnp.float32)
    if name == "MultVAE":
        tm.update_count = 7.0
    step = jax.jit(jm._step_with_key if name in INTERACTION
                   else jm._train_step)
    named = dict(tm.named_parameters())
    for jb, key, tb in _batches(case, jm, tm, rng):
        if name in INTERACTION:
            (params, opt, _), ref_loss = step((params, opt, key), jb)
        elif name == "CDAE":
            (params, opt), ref_loss = step((params, opt), (*jb, key))
        else:
            (params, opt, count), ref_loss = step((params, opt, count),
                                                  (*jb, key))
        loss = tm.train_step(tb)
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
        ref = {"param": convert(jax.tree_util.tree_map(np.asarray, params)),
               "exp_avg": convert(jax.tree_util.tree_map(np.asarray,
                                                         opt[0].mu)),
               "exp_avg_sq": convert(jax.tree_util.tree_map(np.asarray,
                                                            opt[0].nu))}
        assert set(ref["param"]) == set(named)
        for n, p in named.items():
            st = tm.optimizer.state[p]
            got = {"param": p, "exp_avg": st["exp_avg"],
                   "exp_avg_sq": st["exp_avg_sq"]}
            for k, value in got.items():
                np.testing.assert_allclose(value.detach().numpy(),
                                           ref[k][n].numpy(), **TOL,
                                           err_msg=f"{n} {k}")
            assert float(st["step"]) == int(opt[0].count)
        if name == "MultVAE":
            assert float(tm.update_count) == float(count)
    assert int(opt[0].count) == 6
    if name == "MultVAE":
        assert float(count) == 10.0


@pytest.mark.parametrize("case", list(CASES))
def test_program_step_equals_the_eager_epoch(case, data, monkeypatch):
    """The captured route's step body (EpochProgram.step: the permutation
    sliced by an index on the device, the step's draws from the
    program's step generator, the loss summed there) run eagerly over one
    epoch, against the model's eager epoch from the same state and
    generators: the loss, every parameter, Adam's moments and counts,
    MultVAE's anneal count, and both generators' states after the epoch,
    bit for bit."""
    tm = _port(case, data, monkeypatch)
    tm._train_epoch(0)                      # Adam's moments not zero
    start = _saved(tm._train_state())
    seed = tm.run_config.seed + 1

    def generators():
        return (epoch_generator(seed, 1, CPU),
                epoch_generator(seed, 1, CPU, stream=1))
    gen, step_gen = generators()
    loss_eager = tm.run_epoch(gen, step_gen)
    assert tm.pipeline.last_run == {"route": "eager",
                                    "steps": tm.pipeline.num_batches}
    eager = _bits(tm._train_state())
    eager_gens = gen.get_state(), step_gen.get_state()
    # the steps drew from the step generator (SLMRec's FAC draws nothing)
    assert torch.equal(eager_gens[1], generators()[1].get_state()) == (
        case == "SLMRec")
    tm._load_train_state(start)
    gen, step_gen = generators()
    program = tm.pipeline.program(tm.train_step)
    assert program is tm.pipeline.program(tm.train_step)
    assert program.step_generator is not step_gen
    tm._step_gen = program.step_generator
    try:
        loss_program = program.run(gen, step_generator=step_gen)
    finally:
        tm._step_gen = None
    assert int(program.index) == tm.pipeline.num_batches > 1
    assert loss_program == loss_eager
    assert _bits(tm._train_state()) == eager
    assert torch.equal(gen.get_state(), eager_gens[0])
    assert torch.equal(step_gen.get_state(), eager_gens[1])
    if case == "MultVAE":
        assert float(tm.update_count) == 2 * tm.pipeline.num_batches


@pytest.mark.parametrize("case", list(CASES))
def test_state_loads_into_the_step_tensors(case, data, monkeypatch):
    """After ``_load_train_state`` (a checkpoint's per-parameter Adam
    state and MultVAE's anneal count) and after ``load_jax_opt_state``,
    the tensors of ``train_step.state`` are the same objects, holding the
    loaded values: a graph captured before needs no new capture."""
    tm = _port(case, data, monkeypatch)
    tm._train_epoch(0)
    saved = _saved(tm._train_state())
    want = _arrays(saved)
    buffers = tm.train_step.state
    n_params = len(list(tm.parameters()))
    assert len(buffers) == 5 * n_params + (case == "MultVAE")
    tm._train_epoch(1)
    assert _arrays(tm._train_state()).keys() == want.keys()
    tm._load_train_state(saved)
    assert all(a is b for a, b in zip(tm.train_step.state, buffers))
    got = _arrays(tm._train_state())
    for key in want:
        assert torch.equal(got[key], want[key]), key
    if case == "MultVAE":
        assert buffers[-1] is tm.update_count
        assert float(tm.update_count) == tm.pipeline.num_batches
    size = sum(p.numel() for p in tm.parameters())
    tm.load_jax_opt_state(9, np.full(size, 0.5, np.float32),
                          np.full(size, 0.25, np.float32))
    assert all(a is b for a, b in zip(tm.train_step.state, buffers))
    for p in tm.parameters():
        st = tm.optimizer.state[p]
        assert float(st["step"]) == 9.0
        assert float(st["exp_avg"].min()) == float(st["exp_avg"].max()) \
            == 0.5


@pytest.mark.parametrize("name", [*CASES, *FLAT, *EAGER])
def test_captured_route_is_opt_in(name, data, monkeypatch):
    """As on a card (the model's device set to CUDA after it was built on
    the CPU): the five models of this file and the six flat ones take the
    captured route, every other model, whose step has not had its own
    check, the eager loop."""
    case = name if name in CASES else None
    if case is not None:
        tm = _port(case, data, monkeypatch)
    else:
        tm = _build(name, {**FLAT, **EAGER}[name], data, monkeypatch)
    assert not getattr(tm, "captured_epochs", False)       # on the CPU
    monkeypatch.setattr(tm, "device", torch.device("cuda", 0))
    assert getattr(tm, "captured_epochs", False) == (name not in EAGER)


@pytest.mark.parametrize("case", list(CASES))
def test_captured_route_is_refused_on_the_cpu(case, data, monkeypatch):
    """On the CPU fit() takes the eager loop; asking for the captured
    route there raises, and so does a per-leaf step under an optimizer
    whose state it does not make (no ``state``)."""
    from skrx_torch.models.common import make_train_step
    tm = _port(case, data, monkeypatch)
    assert not tm.captured_epochs
    gens = (epoch_generator(2, 0, CPU), epoch_generator(2, 0, CPU, 1))
    with pytest.raises(ValueError, match="CUDA"):
        tm.run_epoch(*gens, captured=True)
    sgd = make_train_step(torch.optim.SGD(tm.parameters(), lr=0.1),
                          tm._loss)
    assert sgd.state is None and tm.train_step.state is not None
    tm.pipeline.device = torch.device("cuda", 0)     # the checks only
    with pytest.raises(TypeError, match="state"):
        tm.pipeline.run_epoch(gens[0], sgd, captured=True)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["SelfCF", "MultVAE"])
def test_card_captured_epoch_equals_the_eager_one(case, data, monkeypatch):
    """On a card: one epoch on the captured route and one on the eager
    route from the same state and generators, bit for bit (loss,
    parameters, Adam's moments and counts, MultVAE's anneal count, both
    generators' end states), the first replayed a step a batch; the
    derived tables (SelfCF's frozen embeddings, MultVAE's cached user
    vectors) move after the replays (needs a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tm = _port(case, data, monkeypatch, device="cuda")
    assert tm.captured_epochs
    users = torch.arange(8, device=tm.device)

    def derived():
        with torch.no_grad():
            return (tm._chunk_embeddings()[0] if case == "SelfCF"
                    else tm._cached_user_vectors(users)).clone()
    before = derived()
    tm._train_epoch(0)
    run = tm.pipeline.last_run
    assert run["route"] == "captured"
    assert run["replays"] == tm.pipeline.num_batches
    if case == "SelfCF":
        tm._final_emb = None            # as fit() drops it after an epoch
    after = derived()
    assert not torch.equal(after, before)
    start = _saved(tm._train_state())
    out = {}
    for route in ("captured", "eager"):
        tm._load_train_state(start)
        seed = tm.run_config.seed + 1
        gen = epoch_generator(seed, 1, tm.device)
        step_gen = epoch_generator(seed, 1, tm.device, stream=1)
        loss = tm.run_epoch(gen, step_gen, captured=route == "captured")
        out[route] = (loss, _bits(tm._train_state()),
                      gen.get_state(), step_gen.get_state())
        if route == "captured":
            assert tm.pipeline.last_run["warmup_steps"] == 0
    (cl, cs, cg, csg), (el, es, eg, esg) = out["captured"], out["eager"]
    assert cl == el and cs == es
    assert torch.equal(cg, eg) and torch.equal(csg, esg)
