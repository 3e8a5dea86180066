"""What the port's fit() gained with the JAX package's: checkpoints and
resume (bit for bit on the CPU), the profiler trace, user groups and
evaluate_group() (metrics within 1e-5 of JAX's from the same weights), the
evaluator's set_train_data / set_test_data (metrics within 1e-6 of a JAX
evaluator built on the new data), and RunConfig's new fields."""
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch

from skrx import RunConfig as JaxRunConfig
from skrx.eval import RankingEvaluator as JaxRankingEvaluator
from skrx.io import RSDataset as JaxRSDataset
from skrx.io import group_users_by_interactions as jax_groups
from skrx.io import synthetic as jax_synthetic
from skrx.models.BPRMF import BPRMF as JaxBPRMF
from skrx_torch import RunConfig
from skrx_torch.eval import RankingEvaluator
from skrx_torch.io import RSDataset, group_users_by_interactions
from skrx_torch.models.BPRMF import BPRMF
from skrx_torch.utils.checkpoint import Checkpointer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Steps of a few small ops: one intra-op thread keeps them fast when
    the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_fit")
    return jax_synthetic.make_dataset_dir(str(root), num_users=40,
                                          num_items=60, num_ratings=800,
                                          seed=4)


def _run(data_dir, ckpt_dir, **over):
    base = dict(data_dir=data_dir, metric=("NDCG",), top_k=(10,),
                test_batch_size=32, seed=2021, checkpoint_dir=ckpt_dir,
                checkpoint_every=1)
    base.update(over)
    return RunConfig(**base)


def _state_arrays(model):
    """Every tensor of the model's training state, flattened by name."""
    out = {}

    def walk(prefix, value):
        if isinstance(value, torch.Tensor):
            out[prefix] = value.detach().clone()
        elif isinstance(value, dict):
            for k, v in value.items():
                walk(f"{prefix}/{k}", v)
    walk("", model._train_state())
    return out


# ---------------------------------------------------------- checkpointer

def test_checkpointer_round_trip_and_retention(tmp_path):
    ck = Checkpointer(str(tmp_path / "c"), keep=2)
    assert ck.latest_step() is None
    assert ck.restore() == (None, {}, None)
    state = {"a": torch.arange(5.0), "b": {"c": torch.ones((2, 2)),
                                           "n": torch.tensor([3], dtype=
                                                             torch.int32)}}
    for step in (0, 1, 2):
        ck.save(step, state, {"epoch": step, "early_stopping":
                              {"counter": step, "best": None}})
    assert ck.latest_step() == 2 and ck._steps() == [1, 2]
    names = sorted(os.listdir(tmp_path / "c"))
    assert names == ["step_00000001.extra.json", "step_00000001.pt",
                     "step_00000002.extra.json", "step_00000002.pt"]
    restored, extra, step = ck.restore(map_location="cpu")
    assert step == 2 and extra == {"epoch": 2, "early_stopping":
                                   {"counter": 2, "best": None}}
    assert torch.equal(restored["a"], state["a"])
    assert restored["b"]["n"].dtype == torch.int32
    _, extra, step = ck.restore(step=1)
    assert step == 1 and extra["epoch"] == 1
    with pytest.raises(ValueError):
        Checkpointer(str(tmp_path / "d"), keep=0)


@pytest.mark.parametrize("optimizer", ["adam", "lazy_adam"])
def test_resume_reproduces_the_uninterrupted_run_bit_for_bit(
        optimizer, data_dir, tmp_path, monkeypatch):
    """6 epochs straight against 3, then a resumed run to 6: parameters and
    optimizer state equal bit for bit; the resumed run starts at epoch 3."""
    monkeypatch.chdir(tmp_path)
    cfg = dict(lr=0.05, reg=0.001, n_dim=8, batch_size=128, epochs=6,
               early_stop=10, optimizer=optimizer)
    full = BPRMF(_run(data_dir, str(tmp_path / "a")), cfg, device="cpu")
    full.fit()
    first = BPRMF(_run(data_dir, str(tmp_path / "b")), dict(cfg, epochs=3),
                  device="cpu")
    first.fit()
    resumed = BPRMF(_run(data_dir, str(tmp_path / "b"), resume=True), cfg,
                    device="cpu")
    resumed.fit()
    assert [h["epoch"] for h in resumed.history] == [3, 4, 5]
    want, got = _state_arrays(full), _state_arrays(resumed)
    assert set(want) == set(got) and len(want) >= 6
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_resume_from_a_sidecar_that_fails_to_load(data_dir, tmp_path,
                                                  monkeypatch):
    """A corrupt extra file: the state alone resumes, after the saved step,
    and early stopping starts over."""
    monkeypatch.chdir(tmp_path)
    cfg = dict(lr=0.05, n_dim=8, batch_size=128, epochs=2, early_stop=10)
    ck_dir = str(tmp_path / "ck")
    BPRMF(_run(data_dir, ck_dir), cfg, device="cpu").fit()
    sidecar = os.path.join(ck_dir, "BPRMF", "step_00000001.extra.json")
    with open(sidecar, "w") as f:
        f.write("{not json")
    full = BPRMF(_run(data_dir, str(tmp_path / "full")), dict(cfg, epochs=4),
                 device="cpu")
    full.fit()
    resumed = BPRMF(_run(data_dir, ck_dir, resume=True), dict(cfg, epochs=4),
                    device="cpu")
    resumed.fit()
    assert [h["epoch"] for h in resumed.history] == [2, 3]
    for key in BPRMF._JAX_PARAMS:
        assert torch.equal(getattr(resumed, key), getattr(full, key))


def test_no_checkpoint_without_a_cadence(data_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    m = BPRMF(_run(data_dir, str(tmp_path / "ck"), checkpoint_every=0,
                   resume=True), dict(n_dim=8, epochs=1), device="cpu")
    assert m._checkpointer() is None
    m.fit()
    assert not os.path.exists(tmp_path / "ck")


def test_profile_dir_writes_a_trace_of_the_second_epoch(data_dir, tmp_path,
                                                        monkeypatch):
    monkeypatch.chdir(tmp_path)
    prof = str(tmp_path / "prof")
    m = BPRMF(RunConfig(data_dir=data_dir, metric=("NDCG",), top_k=(10,),
                        profile_dir=prof),
              dict(n_dim=8, epochs=3, batch_size=256), device="cpu")
    m.fit()
    (name,) = os.listdir(prof)
    assert name.startswith("BPRMF_epoch1_") and name.endswith(".json")
    with open(os.path.join(prof, name)) as f:
        trace = json.load(f)
    assert trace["traceEvents"]


def test_run_config_checks_the_new_fields():
    rc = RunConfig()
    assert (rc.checkpoint_dir, rc.checkpoint_every, rc.resume,
            rc.profile_dir) == ("", 0, False, "")
    for bad in (dict(checkpoint_every=-1), dict(checkpoint_every=1.5),
                dict(resume=1), dict(profile_dir=None),
                dict(checkpoint_dir=3)):
        with pytest.raises(ValueError):
            RunConfig(**bad)


# ------------------------------------------------------------------ groups

@pytest.fixture(scope="module")
def group_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_groups")
    return jax_synthetic.make_dataset_dir(str(root), num_users=150,
                                          num_items=120, num_ratings=3000,
                                          seed=8)


@pytest.mark.parametrize("num_groups", [1, 3, 4, 7])
def test_group_users_by_interactions_matches_jax(group_data, num_groups):
    ref = jax_groups(JaxRSDataset(group_data, "\t", "UIRT"), num_groups)
    got = group_users_by_interactions(RSDataset(group_data, "\t", "UIRT"),
                                      num_groups)
    assert [g.label for g in got] == [g.label for g in ref]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.users, r.users)
        np.testing.assert_array_equal(g.activities, r.activities)
        assert (g.num_users, g.num_interactions) == (r.num_users,
                                                     r.num_interactions)


def test_evaluate_group_matches_jax(group_data, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    run = dict(data_dir=group_data, metric=("NDCG", "Recall"),
               top_k=(5, 10), test_batch_size=32, seed=1)
    jm = JaxBPRMF(JaxRunConfig(recommender="BPRMF", **run), dict(n_dim=8))
    tm = BPRMF(RunConfig(**run), dict(n_dim=8), device="cpu")
    tm.load_jax_params({k: np.asarray(v) for k, v in jm.params.items()})
    ref, got = jm.evaluate_group(), tm.evaluate_group()
    assert len(got) == 4 and [g[0] for g in got] == [r[0] for r in ref]
    for (_, g), (_, r) in zip(got, ref):
        assert list(g.metrics()) == list(r.metrics())
        np.testing.assert_allclose(list(g.values()), list(r.values()),
                                   rtol=0, atol=1e-5)


# ------------------------------------------------------------- evaluator

class _Stub:
    def __init__(self, scores):
        self.scores = scores

    def predict(self, users):
        return self.scores[np.asarray(users, dtype=np.int64)]


def test_set_train_and_test_data_take_effect_in_the_next_evaluate():
    rng = np.random.default_rng(2)
    users, n = 60, 300
    model = _Stub(rng.standard_normal((users, n)).astype(np.float32))

    def split(seed):
        r = np.random.default_rng(seed)
        train, test = {}, {}
        for u in range(users):
            items = r.permutation(n)
            ntr, nte = r.integers(1, 40), r.integers(1, 12)
            train[u] = items[:ntr].astype(np.int32)
            test[u] = items[ntr:ntr + nte].astype(np.int32)
        return train, test
    (train0, test0), (train1, test1) = split(0), split(1)
    kw = dict(metric=("Recall", "NDCG"), top_k=(5, 20), batch_size=16)
    tev = RankingEvaluator(train0, test0, device="cpu", **kw)
    before = tev.evaluate(model)
    assert len(tev._lru) == 1
    for setter, train, test in ((tev.set_test_data, train0, test1),
                                (tev.set_train_data, train1, test1)):
        setter(test if setter == tev.set_test_data else train)
        assert not tev._lru and tev._table_key is None
        ref = JaxRankingEvaluator(train, test, **kw).evaluate(model)
        got = tev.evaluate(model)
        np.testing.assert_allclose(list(got.values()), list(ref.values()),
                                   rtol=0, atol=1e-6)
        assert list(got.values()) != list(before.values())
        before = got
    with pytest.raises(ValueError):
        tev.set_test_data({})
