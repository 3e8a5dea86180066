"""The port's command line (``run_skrx_torch.py``) against the JAX
package's ``run_skrx.py``: the same argv gives the same metrics (Pop, to
1e-6), the same split of flags into run and model keys, the ini overlay
under the CLI; run options (``mesh_shape``, ``compute_dtype`` routing),
the registry's user models and missing models, and no fallback to the
CPU."""
import os
import subprocess
import sys
import warnings

import pytest

jax = pytest.importorskip("jax")
import torch

from skrx.io import synthetic as jax_synthetic
from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.models.BPRMF import BPRMF, BPRMFConfig
from skrx_torch.models.LightGCN import LightGCN
from skrx_torch.models.MultVAE import MultVAE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import run_skrx                                               # noqa: E402
import run_skrx_torch                                         # noqa: E402


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    return jax_synthetic.make_dataset_dir(str(root), num_users=40,
                                          num_items=60, num_ratings=800,
                                          seed=6)


@pytest.fixture(autouse=True)
def _workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)            # models and the CLI write log/


class _Stop(Exception):
    pass


def _spy(monkeypatch, cls, seen):
    """Record the run config and model params a class is built with, then
    stop the run."""
    def init(self, run_config, model_config, *args, **kwargs):
        seen.update(run=dict(run_config.to_dict()), model=dict(model_config),
                    kwargs=kwargs)
        raise _Stop
    monkeypatch.setattr(cls, "__init__", init)


def _both(monkeypatch, argv):
    """(JAX result, port result) of one argv."""
    monkeypatch.setattr(sys, "argv", ["run_skrx.py"] + argv)
    jax_result = run_skrx.main()
    return jax_result, run_skrx_torch.main(argv, device="cpu")


@pytest.mark.parametrize("extra", [
    [],
    ["--test_batch_size", "7", "--seed", "3"],
])
def test_pop_from_the_command_line_equals_jax(data_dir, monkeypatch, extra):
    argv = ["--recommender", "Pop", "--data_dir", data_dir,
            "--file_column", "UIRT", "--top_k", "(10,20)",
            "--metric", "('Recall','NDCG','MRR')"] + extra
    jr, tr = _both(monkeypatch, argv)
    assert list(jr.metrics()) == list(tr.metrics())
    assert len(jr.results) == 6
    for key in jr.metrics():
        assert abs(jr[key] - tr[key]) <= 1e-6, key
    assert tr["NDCG@10"] > 0
    name = os.path.basename(data_dir)
    assert os.listdir(os.path.join("log", name, "Pop"))


def test_lightgcn_from_the_command_line_equals_a_direct_fit(data_dir):
    """The slice's path: flags to config, the seeds, HyperOpt's single
    fit(); bit-equal to building the model by hand."""
    argv = ["--recommender", "LightGCN", "--data_dir", data_dir,
            "--epochs", "2", "--early_stop", "2", "--top_k", "(10,20)",
            "--metric", "('Recall','NDCG')", "--embed_size", "8",
            "--n_layers", "2", "--batch_size", "64", "--lr", "0.01"]
    got = run_skrx_torch.main(argv, device="cpu")
    m = LightGCN(RunConfig(recommender="LightGCN", data_dir=data_dir,
                           top_k=(10, 20), metric=("Recall", "NDCG")),
                 dict(epochs=2, early_stop=2, embed_size=8, n_layers=2,
                      batch_size=64, lr=0.01), device="cpu")
    ref = m.fit()
    assert dict(got.results) == dict(ref.results)
    assert got["NDCG@10"] > 0


def test_ini_overlay_cli_over_ini_and_unknown_flags_match_jax(
        data_dir, tmp_path, monkeypatch):
    ini = tmp_path / "run.ini"
    ini.write_text("[run]\n"
                   "recommender = BPRMF\n"
                   f"data_dir = {data_dir}\n"
                   "top_k = (10,)\n"
                   "n_dim = 12\n"
                   "lr = 0.01\n"
                   "epochs = 1\n"
                   "hyperopt = false\n"
                   "[more]\n"
                   "checkpoint_every = 2\n"
                   "reg = 0.5\n")
    argv = ["--config", str(ini), "--lr", "0.05", "--foo_bar", "3",
            "--test_batch_size", "8", "--resume", "True"]
    import skrx.models.BPRMF as jax_bprmf
    jseen, tseen = {}, {}
    _spy(monkeypatch, jax_bprmf.BPRMF, jseen)
    _spy(monkeypatch, BPRMF, tseen)
    monkeypatch.setattr(sys, "argv", ["run_skrx.py"] + argv)
    with pytest.raises(_Stop):
        run_skrx.main()
    with pytest.raises(_Stop):
        run_skrx_torch.main(argv, device="cpu")
    assert tseen["model"] == jseen["model"] == dict(
        n_dim=12, lr=0.05, epochs=1, reg=0.5, foo_bar=3)
    assert {k: v for k, v in tseen["run"].items() if k in jseen["run"]} \
        == jseen["run"]
    assert set(tseen["run"]) == set(jseen["run"])
    run = tseen["run"]
    assert (run["top_k"], run["test_batch_size"], run["checkpoint_every"],
            run["resume"], run["hyperopt"]) == ((10,), 8, 2, True, False)
    assert tseen["kwargs"] == {"device": "cpu"}
    # the unknown flag reaches the model config, which drops it
    assert not hasattr(BPRMFConfig(**tseen["model"]), "foo_bar")


def test_parse_value_and_overlays_equal_jax(tmp_path):
    from skrx.utils import config as jcfg
    from skrx_torch.utils import config as tcfg
    for text in ("1", "1.5", "(10, 20)", "('NDCG',)", "[1, 2]", "True",
                 "false", "FALSE", " true ", "None", "abc", "\t", "1e-3",
                 "{'a': 1}", "__import__('os')"):
        assert tcfg.parse_value(text) == jcfg.parse_value(text), text
    argv = ["--a", "1", "--b", "x", "--c", "(1,2)"]
    assert tcfg.merge_config_with_cmd_args({"a": 0, "z": 1}, argv) == \
        jcfg.merge_config_with_cmd_args({"a": 0, "z": 1}, argv)
    for bad in (["--a"], ["a", "1"]):
        with pytest.raises(SyntaxError):
            tcfg.merge_config_with_cmd_args({}, bad)
    ini = tmp_path / "x.ini"
    ini.write_text("[s1]\na = 1\nb = true\n[s2]\na = 2\nc = hello\n")
    for sections in (None, ["s1"], ["s2", "s1"]):
        assert tcfg.merge_config_with_ini({}, str(ini), sections) == \
            jcfg.merge_config_with_ini({}, str(ini), sections)
    with pytest.raises(FileNotFoundError):
        tcfg.merge_config_with_ini({}, str(tmp_path / "missing.ini"))


def test_mesh_shape_larger_than_one_device_raises(data_dir, tmp_path,
                                                  monkeypatch):
    """A mesh of several ranks is a valid RunConfig; without the ranks
    (no process group) the model refuses to build, a model outside the
    mesh slice refuses by name (ROADMAP Queue 1 item 4b)."""
    monkeypatch.chdir(tmp_path)
    from skrx_torch.models.LightGCN import LightGCN
    for shape in ((1, 2), (2, 1), [4, 1]):
        run = RunConfig(data_dir=data_dir, mesh_shape=shape)
        assert run.mesh_shape == tuple(shape)
        with pytest.raises(ValueError, match="does not match 1 ranks"):
            LightGCN(run, dict(embed_size=8), device="cpu")
    for bad in ((1,), (0, 1), (1.0, 1)):
        with pytest.raises(ValueError):
            RunConfig(mesh_shape=bad)
    assert RunConfig(mesh_shape=[1, 1]).mesh_shape == (1, 1)
    assert RunConfig().mesh_shape is None
    # every model runs under a mesh, which needs the ranks' process group
    with pytest.raises(ValueError, match="does not match 1 ranks"):
        run_skrx_torch.main(["--recommender", "Pop", "--data_dir", data_dir,
                             "--mesh_shape", "(1,2)"], device="cpu")


def test_compute_dtype_is_routed_as_in_jax(data_dir):
    from skrx import RunConfig as JaxRunConfig
    from skrx.models.BPRMF import BPRMF as JaxBPRMF
    from skrx.models.MultVAE import MultVAE as JaxMultVAE
    with pytest.raises(ValueError):
        RunConfig(compute_dtype="float16")
    bf16 = dict(data_dir=data_dir, compute_dtype="bfloat16")
    small = dict(p_dims=[8], epochs=1)
    for model_cfg, want in ((small, "bfloat16"),
                            (dict(small, compute_dtype="float32"),
                             "float32")):
        tm = MultVAE(RunConfig(**bf16), dict(model_cfg), device="cpu")
        jm = JaxMultVAE(JaxRunConfig(recommender="MultVAE", **bf16),
                        dict(model_cfg))
        assert tm.config.compute_dtype == jm.config.compute_dtype == want
        assert tm.cdt == (torch.bfloat16 if want == "bfloat16"
                          else torch.float32)
    assert MultVAE(RunConfig(data_dir=data_dir), dict(small),
                   device="cpu").config.compute_dtype == "float32"
    with pytest.warns(UserWarning, match="compute_dtype"):
        tb = BPRMF(RunConfig(**bf16), {}, device="cpu")
    with pytest.warns(UserWarning, match="compute_dtype"):
        JaxBPRMF(JaxRunConfig(**bf16), {})
    assert not hasattr(tb.config, "compute_dtype")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        BPRMF(RunConfig(data_dir=data_dir), {}, device="cpu")
    # the model's log carries the routed value
    name = os.path.basename(data_dir)
    logs = [os.path.join("log", name, "MultVAE", f)
            for f in os.listdir(os.path.join("log", name, "MultVAE"))]
    assert any("compute_dtype=bfloat16" in open(f).read() for f in logs)


def test_registry_loads_user_models_and_reports_missing_ones(tmp_path,
                                                             capsys):
    from skrx.utils import ModelRegistry as JaxRegistry
    reg, jreg = ModelRegistry(), JaxRegistry()
    assert reg.load_skrx_model("Nope") is jreg.load_skrx_model("Nope") \
        is False
    assert "Nope" in capsys.readouterr().err
    with pytest.raises(KeyError):
        reg.get_model("Nope")
    assert reg.load_skrec_model("Pop") is True
    assert reg.get_model("Pop")[0].__module__ == "skrx_torch.models.Pop"
    user = tmp_path / "user_models"
    (user / "PkgModel").mkdir(parents=True)
    (user / "FileModel.py").write_text(
        "from skrx_torch.models.Pop import Pop, PopConfig\n"
        "class FileModel(Pop):\n    pass\n"
        "class FileModelConfig(PopConfig):\n    pass\n")
    (user / "PkgModel" / "__init__.py").write_text(
        "from skrx_torch.models.BPRMF import BPRMF as PkgModel\n"
        "from skrx_torch.models.BPRMF import BPRMFConfig as "
        "PkgModelConfig\n")
    (user / "Half.py").write_text("class Half:\n    pass\n")
    assert reg.load_model_from_dir(str(user), "FileModel") is True
    assert reg.load_model_from_dir(str(user), "PkgModel") is True
    assert reg.get_model("PkgModel")[0] is BPRMF
    assert reg.load_model_from_dir(str(user), "Half") is False
    assert reg.load_model_from_dir(str(user), "Absent") is False
    assert reg.list_models() == ["FileModel", "PkgModel", "Pop"]


def test_unarchived_model_runs_from_the_command_line(data_dir, tmp_path):
    (tmp_path / "unarchived_models").mkdir()
    (tmp_path / "unarchived_models" / "MyPop.py").write_text(
        "from skrx_torch.models.Pop import Pop, PopConfig\n"
        "class MyPop(Pop):\n    pass\n"
        "class MyPopConfig(PopConfig):\n    pass\n")
    argv = ["--recommender", "MyPop", "--data_dir", data_dir,
            "--top_k", "(10,)", "--metric", "('NDCG',)"]
    got = run_skrx_torch.main(argv, device="cpu")
    ref = run_skrx_torch.main(["--recommender", "Pop"] + argv[2:],
                              device="cpu")
    assert dict(got.results) == dict(ref.results)


def test_the_command_line_without_cuda_exits_non_zero(data_dir, tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "run_skrx_torch.py"),
         "--recommender", "Pop", "--data_dir", data_dir, "--top_k",
         "(10,)"], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr, out.stderr[-2000:]
