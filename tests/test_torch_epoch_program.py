"""The epoch as one program: the port's flat-parameter step
(``FlatTrainStep``) against the JAX package's jitted
``make_flat_train_step`` (optax Adam), its parameters as views of one flat
vector in JAX's ravel order (MGCN's nested tree key by key, as
``ravel_pytree`` lays it out), the captured route's step body
(``EpochProgram``) run eagerly against the eager epoch bit for bit, and the
captured route refused on the CPU. BPRMF (Adam), LightGCN (2 layers),
FPMC, TransRec, SGAT (2 layers) and MGCN (its LambdaLR schedule computed
inside the step) at widths of 8 on 1,500 synthetic ratings; the captured
route itself (a CUDA graph) runs only on a card, in ``chip_smoke.py``
phases 4, 6, 12 and 14.

On a card the step's Adam is capturable (its bias corrections in f32 on
the device, as optax's), which the CPU cannot run: JAX's flat step over
three batches, from a state with the user table's second moments near
Adam's eps squared, is kept in ``data/flat_step_reference.npz`` for
BPRMF, LightGCN, FPMC and MGCN (whose third step crosses an epoch of its
schedule). The CPU tests hold that file to JAX's step (and the port's CPU
step to it), and the card's test holds the card's step to it. Write the
file anew with ``python -m tests.test_torch_epoch_program``.

JAX is imported inside the tests that run it, so the card's test run,
which has no JAX, runs the rest of the file."""
import io
import os
import sys
import types

import numpy as np
import pytest
import torch

from skrx_torch import RunConfig
from skrx_torch.io import synthetic
from skrx_torch.models.BPRMF import BPRMF
from skrx_torch.models.FPMC import FPMC
from skrx_torch.models.LightGCN import LightGCN
from skrx_torch.models.MGCN import MGCN
from skrx_torch.models.SGAT import SGAT
from skrx_torch.models.TransRec import TransRec
from skrx_torch.models.common import adam_l2, ravel_order
from skrx_torch.models.pipeline import (EpochProgram, epoch_generator,
                                        mark_written)

CPU = torch.device("cpu")
MODELS = {
    "BPRMF": (BPRMF, dict(n_dim=8, lr=0.01, reg=0.05, batch_size=128)),
    "LightGCN": (LightGCN, dict(embed_size=8, n_layers=2, lr=0.01,
                                reg=0.05, batch_size=128)),
    "FPMC": (FPMC, dict(embed_size=8, lr=0.01, reg=0.05, batch_size=128)),
    "TransRec": (TransRec, dict(embed_size=8, lr=0.01, reg=0.05,
                                batch_size=128)),
    "SGAT": (SGAT, dict(embed_size=8, n_layers=2, n_seqs=3, n_next=2,
                        lr=0.01, reg=0.05, batch_size=128)),
    "MGCN": (MGCN, dict(embed_dim=8, knn_k=5, lr=0.01, reg=0.1, cl_loss=0.5,
                        batch_size=128, lr_scheduler=[0.5, 50])),
}
# the models whose batches carry the previous items, (users, pos, neg, w,
# prev); the others' are (users, pos, neg, w)
SEQUENTIAL = ("FPMC", "TransRec", "SGAT")
# the JAX models run their segment route (their "auto" may take Pallas)
SEGMENT = ("LightGCN", "SGAT", "MGCN")
# the models of the stored reference, and each one's user table, whose
# second moments start near eps**2
REFERENCE_MODELS = {"BPRMF": "user_emb", "LightGCN": "user_emb",
                    "FPMC": "UI", "MGCN": "user_emb"}
# the models whose user rows outside the batches keep a zero gradient
# (no propagation reaches them): their user table
STILL = {"BPRMF": "user_emb", "FPMC": "UI"}
RUN = dict(seed=1, metric=("NDCG",), top_k=(10,), test_batch_size=32)
REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                         "flat_step_reference.npz")
# the reference's Adam count: bias corrections near 1, so that a second
# moment near eps**2 puts sqrt(nu_hat) near eps
REF_COUNT = 3000
BATCH_KEYS = ("users", "pos", "neg", "w", "prev")


def _jax():
    """The JAX side: jax, its ravel, and the JAX package's models."""
    jax = pytest.importorskip("jax")
    from jax.flatten_util import ravel_pytree

    from skrx import RunConfig as JaxRunConfig
    from skrx.models.BPRMF import BPRMF as JaxBPRMF
    from skrx.models.FPMC import FPMC as JaxFPMC
    from skrx.models.LightGCN import LightGCN as JaxLightGCN
    from skrx.models.MGCN import MGCN as JaxMGCN
    from skrx.models.SGAT import SGAT as JaxSGAT
    from skrx.models.TransRec import TransRec as JaxTransRec
    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, ravel=ravel_pytree, RunConfig=JaxRunConfig,
        models={"BPRMF": JaxBPRMF, "LightGCN": JaxLightGCN,
                "FPMC": JaxFPMC, "TransRec": JaxTransRec, "SGAT": JaxSGAT,
                "MGCN": JaxMGCN})


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _make_data(root: str) -> str:
    """50 users, 80 items, 1,500 ratings (seed 9), with 12-d image and
    10-d text features (drawn from their own generator: the ratings are
    those of the data without them)."""
    return synthetic.make_dataset_dir(root, num_users=50, num_items=80,
                                      num_ratings=1500, seed=9, with_mm=True,
                                      img_dim=12, txt_dim=10)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_epoch_program")
    return str(root), _make_data(str(root))


def _port(name, data, monkeypatch, device="cpu"):
    root, path = data
    monkeypatch.chdir(root)
    return MODELS[name][0](RunConfig(data_dir=path, **RUN),
                           dict(MODELS[name][1]), device=device)


def _weights(m, rng):
    """Random weights of the port model's parameters (drawn in their
    order), as JAX's params: nested by the dotted names."""
    return _nest({k: rng.standard_normal(tuple(p.shape)).astype(
        np.float32) * 0.3 for k, p in m.named_parameters()})


def _nest(flat: dict) -> dict:
    out = {}
    for name, value in flat.items():
        *path, leaf = name.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return out


def _dotted(tree, prefix: str = "") -> dict:
    """A nested dict's leaves by dotted name, in JAX's ravel order."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_dotted(value, name + "."))
        else:
            out[name] = np.asarray(value)
    return {k: out[k] for k in ravel_order(out)}


def _size(params) -> int:
    return sum(v.size for v in _dotted(params).values())


def _random_batch(name, tm, rng, users_hi=None, b=32):
    """A batch of model ``name``'s layout: users below ``users_hi`` (all
    when None), positives, negatives (SGAT's ``n_next`` a row), weights
    with about 10% padded rows of 0, and a sequential model's previous
    items (SGAT's pre-padded with id N)."""
    n = tm.num_items
    slots = tm.config.n_next if name == "SGAT" else 1
    batch = [rng.integers(0, users_hi or tm.num_users, b),
             rng.integers(0, n, (b, slots)) if name == "SGAT"
             else rng.integers(0, n, b),
             rng.integers(0, n, (b, slots)),
             (rng.random(b) < 0.9).astype(np.float32)]
    if name in SEQUENTIAL:
        width = tm.config.n_seqs if name == "SGAT" else 1
        batch.append(rng.integers(0, n + (name == "SGAT"), (b, width)))
    return tuple(batch)


def _arrays(state) -> dict:
    """Every tensor of a nested training state, copied, by path."""
    out = {}

    def walk(prefix, value):
        if isinstance(value, torch.Tensor):
            out[prefix] = value.detach().clone()
        elif isinstance(value, dict):
            for k, v in value.items():
                walk(f"{prefix}/{k}", v)
    walk("", state)
    return out


def _bits(state) -> dict:
    return {k: v.numpy().tobytes() for k, v in _arrays(state).items()}


def _saved(state: dict) -> dict:
    """A training or optimizer state as a checkpoint holds it (saved and
    loaded: its tensors are the live ones or their views until then)."""
    buf = io.BytesIO()
    torch.save(state, buf)
    buf.seek(0)
    return torch.load(buf)


_JAX_MODELS = {}


def _jax_model(j, name, path):
    """The JAX package's model ``name`` on ``path``, built once (its step
    and optimizer are pure functions)."""
    if (name, path) not in _JAX_MODELS:
        cfg = dict(MODELS[name][1])
        if name in SEGMENT:
            cfg["graph_impl"] = "segment"
        _JAX_MODELS[name, path] = j.models[name](
            j.RunConfig(recommender=name, data_dir=path, **RUN), cfg)
    jm = _JAX_MODELS[name, path]
    assert hasattr(jm, "_flat")             # JAX's make_flat_train_step
    return jm


def _jax_opt_state(j, jm, flat, count, mu, nu):
    """JAX's optimizer state over ``flat`` at ``count`` with the moments
    given; a schedule's count (MGCN's) moved with Adam's."""
    adam, *rest = jm.optimizer.init(flat)
    c = j.jnp.asarray(count, j.jnp.int32)
    rest = [r._replace(count=c) if "count" in getattr(r, "_fields", ())
            else r for r in rest]
    return (adam._replace(count=c, mu=j.jnp.asarray(mu),
                          nu=j.jnp.asarray(nu)), *rest)


def _jax_steps(j, jm, params, count, mu, nu, batches):
    """JAX's jitted flat step over ``batches`` from ``params`` and the Adam
    state: per step (loss, flat parameters, mu, nu, count)."""
    flat, _ = j.ravel(j.jax.tree_util.tree_map(j.jnp.asarray, params))
    carry = (flat, _jax_opt_state(j, jm, flat, count, mu, nu))
    step = j.jax.jit(jm._train_step)
    out = []
    for batch in batches:
        carry, loss = step(carry, tuple(
            j.jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)
            for x in batch))
        ref = carry[1][0]
        out.append((float(loss), np.asarray(carry[0]), np.asarray(ref.mu),
                    np.asarray(ref.nu), int(ref.count)))
    return out


def _port_steps(tm, params, count, mu, nu, batches):
    """The port's flat step over ``batches`` from the same state: per step
    (loss, flat parameters, exp_avg, exp_avg_sq, step count, each
    parameter by name)."""
    tm.load_jax_params(params)
    tm.load_jax_opt_state(count, mu, nu)
    adam = tm.optimizer.state[tm._flat_step.flat]
    out = []
    for batch in batches:
        loss = tm.train_step(tuple(_t(x).to(tm.device) for x in batch))
        out.append((float(loss),
                    *(t.detach().cpu().numpy().copy() for t in
                      (tm._flat_step.flat, adam["exp_avg"],
                       adam["exp_avg_sq"])),
                    float(adam["step"]),
                    {k: tm.get_parameter(k).detach().cpu().numpy().copy()
                     for k in _dotted(params)}))
    return out


def _assert_steps(got, want, start=None, still=()):
    """Each step's loss within 1e-5 relative; the flat parameters and
    moments within rtol 1e-5, atol 1e-6 (test_torch_train.py's
    tolerances); the count equal. ``still``: entries of the vector whose
    gradient is 0 in every step and whose second moments start near
    eps**2, so that their update leans on eps: their second moments and
    each step's update (from ``start``, the flat parameters before the
    first, up to the ulps of the parameters it is read from) held within
    1e-5 relative as well."""
    prev = r_prev = start
    for (loss, flat, m, v, n, *_), (r_loss, r_flat, r_m, r_v, r_n) in zip(
            got, want):
        np.testing.assert_allclose(loss, r_loss, rtol=1e-5)
        for a, b in ((flat, r_flat), (m, r_m), (v, r_v)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        if len(still):
            np.testing.assert_allclose(v[still], r_v[still], rtol=1e-5,
                                       atol=0)
            # an update read as a difference of f32 parameters: up to an
            # ulp of each
            ulp = np.spacing(np.abs(r_flat[still]).max())
            np.testing.assert_allclose((flat - prev)[still],
                                       (r_flat - r_prev)[still], rtol=1e-5,
                                       atol=2 * ulp)
        prev, r_prev = flat, r_flat
        assert n == r_n


@pytest.mark.parametrize("name", list(MODELS))
def test_flat_step_matches_jax_flat_step(name, data, monkeypatch):
    """The same weights and Adam state in both, then three fixed batches
    through JAX's jitted flat step and the port's: each step's loss, and
    after it the flat parameters and Adam's moments and count; each
    parameter after each step as JAX's unravelled one."""
    j = _jax()
    root, path = data
    monkeypatch.chdir(root)
    jm = _jax_model(j, name, path)
    tm = _port(name, data, monkeypatch)
    rng = np.random.default_rng(4)
    params = _weights(tm, rng)
    size = _size(params)
    mu = rng.standard_normal(size).astype(np.float32) * 0.05
    nu = rng.uniform(1e-3, 1e-2, size).astype(np.float32)
    batches = [_random_batch(name, tm, rng) for _ in range(3)]
    # MGCN from two updates before an epoch's end: its third step at the
    # next epoch's rate
    count = tm.steps_per_epoch - 2 if name == "MGCN" else 4
    want = _jax_steps(j, jm, params, count, mu, nu, batches)
    got = _port_steps(tm, params, count, mu, nu, batches)
    _assert_steps(got, want)
    _, unravel = j.ravel(j.jax.tree_util.tree_map(j.jnp.asarray, params))
    for step, ref_step in zip(got, want):
        ref = _dotted(unravel(j.jnp.asarray(ref_step[1])))
        assert ref.keys() == step[-1].keys()
        for key in ref:
            np.testing.assert_allclose(step[-1][key], ref[key], rtol=1e-5,
                                       atol=1e-6, err_msg=key)


def _reference_count(name: str, tm) -> int:
    """The reference's Adam count: REF_COUNT, or for MGCN the count two
    updates before the end of the epoch at it, so that its third step
    takes the next epoch's rate."""
    if name != "MGCN":
        return REF_COUNT
    spe = tm.steps_per_epoch
    return spe * (REF_COUNT // spe + 1) - 2


def _reference_inputs(name: str, tm) -> dict:
    """Weights, Adam state and three batches for model ``tm`` (seed 5):
    its user table's second moments in [0.5, 2] * 1e-16 and its first
    moments within 1e-8 (at count REF_COUNT, sqrt(nu_hat) near eps), the
    other leaves' in [1e-3, 1e-2]; the batches' users in the first half,
    so that BPRMF's and FPMC's other half keeps a zero gradient."""
    rng = np.random.default_rng(5)
    params = _weights(tm, rng)
    size = _size(params)
    leaf = _leaf(params, REFERENCE_MODELS[name])
    mu = rng.standard_normal(size).astype(np.float32) * 0.05
    nu = rng.uniform(1e-3, 1e-2, size).astype(np.float32)
    mu[leaf] = rng.uniform(-1e-8, 1e-8, leaf.stop - leaf.start)
    nu[leaf] = rng.uniform(0.5e-16, 2e-16, leaf.stop - leaf.start)
    out = {f"w/{k}": v for k, v in _dotted(params).items()}
    out.update(count=np.int64(_reference_count(name, tm)), mu=mu, nu=nu)
    for i in range(3):
        batch = _random_batch(name, tm, rng, users_hi=tm.num_users // 2)
        out.update({f"b{i}/{k}": v for k, v in zip(BATCH_KEYS, batch)})
    return out


def _leaf(params: dict, key: str) -> slice:
    """``key``'s slice of the vector raveled in JAX's order."""
    lo = 0
    for k, v in _dotted(params).items():
        if k == key:
            return slice(lo, lo + v.size)
        lo += v.size
    raise KeyError(key)


def _still(name: str, params: dict, batches) -> np.ndarray:
    """BPRMF's and FPMC's entries of user rows that no batch gathers
    (their gradient is 0), in the raveled vector; none for the graph
    models, whose propagation reaches every row."""
    if name not in STILL:
        return np.zeros(0, np.int64)
    table = params[STILL[name]]
    d = table.shape[1]
    rows = np.setdiff1d(np.arange(table.shape[0]),
                        np.concatenate([b[0] for b in batches]))
    lo = _leaf(params, STILL[name]).start
    return (lo + rows[:, None] * d + np.arange(d)).reshape(-1)


def _start(params: dict) -> np.ndarray:
    return np.concatenate([v.reshape(-1) for v in _dotted(params).values()])


def _unpack(ref: dict):
    """(params, count, mu, nu, batches) of one model's reference inputs."""
    params = _nest({k[2:]: v for k, v in ref.items() if k.startswith("w/")})
    batches = [tuple(ref[f"b{i}/{x}"] for x in BATCH_KEYS
                     if f"b{i}/{x}" in ref) for i in range(3)]
    return params, int(ref["count"]), ref["mu"], ref["nu"], batches


def _reference_steps(ref: dict) -> list:
    return [(float(ref["loss"][i]), ref["flat"][i], ref["mu_out"][i],
             ref["nu_out"][i], float(ref["count_out"][i])) for i in range(3)]


def _load_reference(name: str) -> dict:
    with np.load(REFERENCE) as f:
        return {k[len(name) + 1:]: f[k] for k in f.files
                if k.startswith(name + "/")}


def _jax_reference(name: str, data) -> dict:
    """One model's reference: its inputs and JAX's steps over them."""
    j = _jax()
    root, path = data
    tm = MODELS[name][0](RunConfig(data_dir=path, **RUN),
                         dict(MODELS[name][1]), device="cpu")
    ref = _reference_inputs(name, tm)
    steps = _jax_steps(j, _jax_model(j, name, path), *_unpack(ref))
    for i, key in enumerate(("loss", "flat", "mu_out", "nu_out",
                             "count_out")):
        ref[key] = np.stack([np.asarray(s[i]) for s in steps])
    return ref


@pytest.mark.parametrize("name", list(REFERENCE_MODELS))
def test_flat_step_reference_is_jax_flat_step(name, data, monkeypatch):
    """The stored reference: its inputs are this file's, its steps JAX's
    jitted flat step over them (within 1e-6 relative: XLA's CPU code may
    round differently elsewhere), and the port's CPU step, whose Adam
    takes its bias corrections in f64, holds to it at the tolerances of
    ``_assert_steps`` (BPRMF's and FPMC's user rows no batch reaches held
    in their update and second moments too; MGCN's third step at the next
    epoch's rate)."""
    monkeypatch.chdir(data[0])
    got, ref = _jax_reference(name, data), _load_reference(name)
    assert got.keys() == ref.keys()
    for key in got:
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-6, atol=0,
                                   err_msg=key)
    params, *state = _unpack(ref)
    assert 1e-17 < ref["nu"][_leaf(params, REFERENCE_MODELS[name])].max() \
        < 1e-15
    still = _still(name, params, state[-1])
    assert name not in STILL or len(still) >= 20 * 8
    tm = _port(name, data, monkeypatch)
    _assert_steps(_port_steps(tm, params, *state), _reference_steps(ref),
                  _start(params), still)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(REFERENCE_MODELS))
def test_card_flat_step_matches_jax_reference(name, data, monkeypatch):
    """On a card: the flat step with its capturable Adam (count and bias
    corrections in f32 on the device; MGCN's rate from its schedule on the
    device) over the stored reference's three batches against JAX's flat
    step, at the tolerances of ``_assert_steps`` (BPRMF's and FPMC's user
    rows no batch reaches, whose second moments sit near eps**2, held in
    their update and second moments too; needs a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ref = _load_reference(name)
    tm = _port(name, data, monkeypatch, device="cuda")
    assert tm.optimizer.defaults["capturable"]
    params, *state = _unpack(ref)
    got = _port_steps(tm, params, *state)
    torch.cuda.synchronize()
    _assert_steps(got, _reference_steps(ref), _start(params),
                  _still(name, params, state[-1]))


@pytest.mark.parametrize("name", list(MODELS))
def test_parameters_are_views_of_the_flat_vector(name, data, monkeypatch):
    """Each parameter, and its gradient, is a view of the one flat vector,
    and of the one flat gradient, at its place in JAX's ravel order: the
    leaves of ``ravel_pytree`` (MGCN's nested tree key by key) at their
    offsets and shapes; a write into the vector shows in the parameter and
    moves its version."""
    j = _jax()
    tm = _port(name, data, monkeypatch)
    step = tm._flat_step
    params = _weights(tm, np.random.default_rng(2))
    tm.load_jax_params(params)
    tree = j.jax.tree_util.tree_map(j.jnp.asarray, params)
    ref, _ = j.ravel(tree)
    np.testing.assert_array_equal(step.flat.detach().numpy(),
                                  np.asarray(ref))
    leaves = j.jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(leaves) == len(step.slices) == len(step.names)
    offset = 0
    for path, leaf in leaves:
        key = ".".join(str(part.key) for part in path)
        assert step.slices[key][:2] == (offset, offset + leaf.size), key
        p = tm.get_parameter(key)
        assert tuple(p.shape) == leaf.shape
        assert p.data_ptr() == step.flat.data_ptr() + 4 * offset
        assert p.grad.data_ptr() == step.grad.data_ptr() + 4 * offset
        offset += leaf.size
    assert offset == step.flat.numel()
    assert [n for n, _ in tm.named_parameters()] == list(step.names)
    if tm._JAX_PARAMS:
        assert list(step.names) == list(tm._JAX_PARAMS)
    key = ravel_order(step.names)[-1]
    p = tm.get_parameter(key)
    version = p._version
    with torch.no_grad():
        step.flat[-1] = 7.0
    assert float(p.detach().reshape(-1)[-1]) == 7.0 and p._version > version


@pytest.mark.parametrize("name", list(MODELS))
def test_state_loads_into_the_flat_buffers(name, data, monkeypatch):
    """A checkpoint holds the Adam state per parameter (as a mesh's and as
    before); loading it, or JAX's Adam state, copies into the buffers a
    captured graph holds: the same tensors before and after."""
    tm = _port(name, data, monkeypatch)
    tm._train_epoch(0)
    saved = _saved(tm._train_state())
    want = _arrays(saved)
    shapes = [tuple(tm.get_parameter(k).shape) for k in tm._flat_step.names]
    assert [tuple(s["exp_avg"].shape) for s in
            saved["optimizer"]["state"].values()] == shapes
    buffers = tm._flat_step.state
    tm._train_epoch(1)
    tm._load_train_state(saved)
    assert all(a is b for a, b in zip(tm._flat_step.state, buffers))
    got = _arrays(tm._train_state())
    assert want.keys() == got.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key
    size = tm._flat_step.flat.numel()
    tm.load_jax_opt_state(9, np.full(size, 0.5, np.float32),
                          np.full(size, 0.25, np.float32))
    assert all(a is b for a, b in zip(tm._flat_step.state, buffers))
    assert float(buffers[4]) == 9.0 and float(buffers[2].min()) == 0.5
    if name == "MGCN":                    # the schedule's count is Adam's
        assert tm.update_count == 9
    with pytest.raises(ValueError):
        tm.load_jax_opt_state(1, np.zeros(3), np.zeros(3))


@pytest.mark.parametrize("name", list(MODELS))
def test_program_step_equals_the_eager_epoch(name, data, monkeypatch):
    """The captured route's step body (EpochProgram.step: the permutation
    sliced by an index on the device, the loss summed there) run eagerly
    over one epoch, against run_epoch's eager loop from the same state
    and generator: the loss, every parameter, Adam's moments and count,
    and the generator's state after the epoch, bit for bit."""
    tm = _port(name, data, monkeypatch)
    tm._train_epoch(0)                      # Adam's moments not zero
    start = _saved(tm._train_state())
    gen = epoch_generator(tm.run_config.seed + 1, 1, CPU)
    loss_eager = tm.pipeline.run_epoch(gen, tm.train_step)
    assert tm.pipeline.last_run == {"route": "eager",
                                    "steps": tm.pipeline.num_batches}
    eager, eager_gen = _bits(tm._train_state()), gen.get_state()
    tm._load_train_state(start)
    gen = epoch_generator(tm.run_config.seed + 1, 1, CPU)
    program = EpochProgram(tm.pipeline, tm.train_step)
    loss_program = program.run(gen)
    assert int(program.index) == tm.pipeline.num_batches > 1
    assert loss_program == loss_eager
    assert _bits(tm._train_state()) == eager
    assert torch.equal(gen.get_state(), eager_gen)


def test_mgcn_rate_is_optax_schedule(data, monkeypatch):
    """MGCN's rate, as the flat step computes it from Adam's f32 count
    (``mgcn_lr_f32``), against the rate by which JAX's jitted optax
    update scales its Adam direction at counts spe - 1, spe and 2 spe
    (spe fixed when the model is built, as JAX's): optax's update
    ``-lr(count) * u`` equals ``-rate * u`` in f32 for every entry with
    the port's rate (spe - 1: the rate of epoch 0, ``lr`` itself) or with
    one of its f32 neighbours (the powers of XLA and of the C library
    round apart by up to an ulp)."""
    j = _jax()
    import optax
    root, path = data
    monkeypatch.chdir(root)
    jm = _jax_model(j, "MGCN", path)
    tm = _port("MGCN", data, monkeypatch)
    spe = tm.steps_per_epoch
    assert spe == jm.pipeline.num_batches >= 2
    tm.pipeline.num_batches = 1            # a cut epoch leaves spe alone
    rng = np.random.default_rng(6)
    g, mu = (j.jnp.asarray(rng.standard_normal(64).astype(np.float32))
             for _ in range(2))
    nu = j.jnp.asarray(rng.uniform(1e-3, 1e-2, 64).astype(np.float32))
    update = j.jax.jit(jm.optimizer.update)
    direction = j.jax.jit(optax.scale_by_adam().update)
    for count in (spe - 1, spe, 2 * spe):
        state = _jax_opt_state(j, jm, j.jnp.zeros(64), count, mu, nu)
        full = np.asarray(update(g, state)[0])
        u = np.asarray(direction(g, state[0])[0])
        rate = tm._flat_step.schedule(torch.tensor(float(count))).numpy()
        assert rate.dtype == np.float32
        near = [rate] if count < spe else \
            [rate, np.nextafter(rate, np.float32(0)),
             np.nextafter(rate, np.float32(1))]
        assert any(np.array_equal(full, u * -r) for r in near), \
            (count, rate, -full / u)
        if count < spe:
            assert rate == np.float32(MODELS["MGCN"][1]["lr"])
    tm.update_count = spe                  # the step reads Adam's count
    assert float(tm._flat_step.next_lr()) == float(
        tm._flat_step.schedule(torch.tensor(float(spe))))


@pytest.mark.parametrize("name", ["FPMC", "TransRec"])
def test_caches_follow_a_replays_writes(name, data, monkeypatch):
    """A replay writes the flat vector without moving its version counter;
    run_epoch's captured route then moves the step's tensors' counters
    (``mark_written``), which the views share: FPMC's concatenated tables
    (``_chunk_embeddings``) and TransRec's user vectors
    (``_cached_user_vectors``) are computed anew, as after an eager
    step."""
    tm = _port(name, data, monkeypatch)
    users = torch.arange(8)

    def derived():
        return (tm._chunk_embeddings()[0] if name == "FPMC"
                else tm._cached_user_vectors(users)).clone()
    before = derived()
    tm._flat_step.flat.detach().numpy()[:] += 0.5     # as a replay writes
    assert torch.equal(derived(), before)             # the counters stand
    mark_written(tm._flat_step.state)
    assert not torch.equal(derived(), before)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["FPMC", "TransRec"])
def test_card_captured_epoch_moves_the_caches(name, data, monkeypatch):
    """On a card: an epoch on the captured route moves FPMC's concatenated
    tables and TransRec's user vectors, the epoch replayed a step a batch
    (needs a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tm = _port(name, data, monkeypatch, device="cuda")
    assert tm.captured_epochs
    users = torch.arange(8, device=tm.device)

    def derived():
        return (tm._chunk_embeddings()[0] if name == "FPMC"
                else tm._cached_user_vectors(users)).clone()
    before = derived()
    tm._train_epoch(0)
    run = tm.pipeline.last_run
    assert run["route"] == "captured"
    assert run["replays"] == tm.pipeline.num_batches
    assert not torch.equal(derived(), before)


def test_adam_keeps_its_device_choice_on_load():
    """``adam_l2`` is capturable only over CUDA parameters, and keeps that
    when it loads a state saved by a capturable Adam (a card's checkpoint
    on the CPU): the CPU's steps on from it as the saving Adam does."""
    params = [torch.nn.Parameter(torch.linspace(-1, 1, 5)) for _ in "ab"]
    saving, loading = (adam_l2([p], 0.1) for p in params)
    assert not saving.defaults["capturable"]
    params[0].grad = torch.linspace(0.5, 2, 5)
    saving.step()
    state = _saved(saving.state_dict())
    state["param_groups"][0]["capturable"] = True         # as a card's
    with torch.no_grad():
        params[1].copy_(params[0])
    loading.load_state_dict(state)
    assert loading.param_groups[0]["capturable"] is False
    for p, adam in zip(params, (saving, loading)):
        p.grad = torch.linspace(-1, 3, 5)
        adam.step()
    assert torch.equal(params[0], params[1])


def test_captured_route_is_refused_on_the_cpu(data, monkeypatch):
    """On the CPU fit() takes the eager loop; asking for the captured
    route there raises, and so does a step whose tensors do not stay in
    place."""
    tm = _port("LightGCN", data, monkeypatch)
    assert not tm.captured_epochs
    gen = epoch_generator(2, 0, CPU)
    with pytest.raises(ValueError, match="CUDA"):
        tm.pipeline.run_epoch(gen, tm.train_step, captured=True)
    tm.pipeline.device = torch.device("cuda", 0)     # the checks only
    with pytest.raises(TypeError, match="state"):
        tm.pipeline.run_epoch(gen, lambda batch: batch[0].sum(),
                              captured=True)


def _write_reference() -> None:
    import tempfile
    ref = {}
    with tempfile.TemporaryDirectory() as root:
        cwd = os.getcwd()
        os.chdir(root)                    # model construction writes log/
        try:
            for name in REFERENCE_MODELS:
                ref.update({f"{name}/{k}": v for k, v in _jax_reference(
                    name, (root, _make_data(root))).items()})
        finally:
            os.chdir(cwd)
    os.makedirs(os.path.dirname(REFERENCE), exist_ok=True)
    np.savez_compressed(REFERENCE, **ref)
    print(f"wrote {REFERENCE}", file=sys.stderr)


if __name__ == "__main__":
    _write_reference()
