"""The port's search driver (``skrx_torch.utils.hyperopt_driver.HyperOpt``)
against the JAX package's, on a deterministic stub model per package whose
``fit()`` returns that package's ``MetricReport`` from its parameters:
the grid fallback (no ``hyperopt`` library) and the TPE branch (through
``tests/fake_hyperopt.py``) build the same trials in the same order, stop
at the same trial, pick the same best parameters, return the same result
and log the same rows (times and paths set aside)."""
import glob
import os
import sys

import pytest

pytest.importorskip("jax")

from skrx import RunConfig as JaxRunConfig
from skrx.eval import MetricReport as JaxMetricReport
from skrx.utils import ModelConfig as JaxModelConfig
from skrx.utils.hyperopt_driver import HyperOpt as JaxHyperOpt
from skrx_torch import ModelConfig, RunConfig
from skrx_torch.eval import MetricReport
from skrx_torch.utils.hyperopt_driver import HyperOpt
from tests import fake_hyperopt

GRIDS = {
    # 30 combos, patience 15: the search stops before the grid's best
    "stops": {"lr": [0.001, 0.005, 0.01, 0.05, 0.1, 0.5],
              "reg": [0.0, 0.001, 0.01, 0.1, 1.0]},
    # 4 combos, patience 10: the whole grid
    "whole": {"lr": [0.05, 0.01], "reg": [0.0, 0.001]},
}


def _score(params) -> float:
    """A deterministic NDCG@10 with its maximum inside the grid."""
    return 0.5 - abs(params["lr"] - 0.01) - 0.1 * params["reg"] \
        + 0.001 * params["n_dim"]


def _stub(report_cls, config_base, grid, takes_device):
    calls = []

    class StubConfig(config_base):
        lr = 0.001
        reg = 0.0
        n_dim = 8

        @classmethod
        def param_space(cls):
            return grid

    class Stub:
        def __init__(self, run_config, model_config, **kwargs):
            assert bool(kwargs) == takes_device
            calls.append((dict(model_config), kwargs.get("device")))
            self.params = {"lr": 0.001, "reg": 0.0, "n_dim": 8,
                           **model_config}

        def fit(self):
            s = _score(self.params)
            return report_cls(["Recall@10", "NDCG@10"], [2 * s, s])

    return Stub, StubConfig, calls


def _search(tmp_path, monkeypatch, grid, hyperopt_module):
    """(JAX's (result, calls, driver, log), the port's) of one search."""
    monkeypatch.setitem(sys.modules, "hyperopt", hyperopt_module)
    out = []
    for pkg, run_cls, report_cls, base, driver_cls in (
            ("jax", JaxRunConfig, JaxMetricReport, JaxModelConfig,
             JaxHyperOpt),
            ("torch", RunConfig, MetricReport, ModelConfig, HyperOpt)):
        work = tmp_path / pkg
        work.mkdir()
        monkeypatch.chdir(work)
        stub, cfg, calls = _stub(report_cls, base, grid, pkg == "torch")
        run = run_cls(data_dir=str(tmp_path / "toy"), seed=7, hyperopt=True)
        kwargs = {"device": "cpu"} if pkg == "torch" else {}
        driver = driver_cls(run, stub, cfg, {"n_dim": 16, "epochs": 1},
                            **kwargs)
        result = driver.run()
        logs = glob.glob(str(work / "log" / "toy" / "Stub" /
                             "hyperopt_toy_Stub_*.log"))
        assert len(logs) == 1
        out.append((result, calls, driver, open(logs[0]).read()))
    return out


def _body(text: str, tsv: bool):
    """The log from the grid's line on; TSV rows without their two time
    columns."""
    lines = text.split("Hyper-Parameters Info:")[1].splitlines()
    if tsv:
        lines = ["\t".join(line.split("\t")[:-2]) if line.count("\t") >= 3
                 else line for line in lines]
    return lines


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_grid_fallback_equals_jax(tmp_path, monkeypatch, grid):
    (jr, jcalls, _, jlog), (tr, tcalls, _, tlog) = _search(
        tmp_path, monkeypatch, GRIDS[grid], None)
    assert [c for c, _ in tcalls] == [c for c, _ in jcalls]
    assert all(dev == "cpu" for _, dev in tcalls)
    n = len(GRIDS[grid]["lr"]) * len(GRIDS[grid]["reg"])
    assert (len(tcalls) < n) if grid == "stops" else (len(tcalls) == n)
    assert dict(tr.results) == dict(jr.results)
    assert tr["NDCG@10"] == max(_score(c) for c, _ in tcalls)
    assert _body(tlog, False) == _body(jlog, False)
    best = [line for line in tlog.splitlines()
            if line.startswith("Best params:")]
    assert len(best) == 1 and best[0] in jlog.splitlines()
    assert "grid search over" in tlog and "skrx_torch version" in tlog


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_tpe_branch_equals_jax(tmp_path, monkeypatch, grid):
    (jr, jcalls, jd, jlog), (tr, tcalls, td, tlog) = _search(
        tmp_path, monkeypatch, GRIDS[grid], fake_hyperopt)
    assert td._have_hyperopt and jd._have_hyperopt
    assert [c for c, _ in tcalls] == [c for c, _ in jcalls]
    assert dict(tr.results) == dict(jr.results)
    assert td._best_params == jd._best_params
    best = max(tcalls, key=lambda c: _score(c[0]))[0]
    assert td._best_params == {k: best[k] for k in ("lr", "reg")}
    assert tr["NDCG@10"] == _score(best)
    assert _body(tlog, True) == _body(jlog, True)
    rows = [line for line in tlog.split("Best params:")[0].splitlines()
            if line[:1].isdigit()]
    n = len(GRIDS[grid]["lr"]) * len(GRIDS[grid]["reg"])
    assert len(rows) == len(tcalls)
    assert (len(rows) < n) if grid == "stops" else (len(rows) == n)
    assert f"fmin max evals count:\t{n}" in tlog


def test_without_search_one_fit_on_the_given_device(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    stub, cfg, calls = _stub(MetricReport, ModelConfig, GRIDS["whole"],
                             True)
    run = RunConfig(data_dir=str(tmp_path / "toy"), hyperopt=False)
    got = HyperOpt(run, stub, cfg, {"lr": 0.05}, device="cpu").run()
    assert calls == [({"lr": 0.05}, "cpu")]
    assert got["NDCG@10"] == _score({"lr": 0.05, "reg": 0.0, "n_dim": 8})
    # a config without a grid turns the search off
    run = RunConfig(data_dir=str(tmp_path / "toy"), hyperopt=True)
    stub, _, calls = _stub(MetricReport, ModelConfig, {}, True)
    HyperOpt(run, stub, ModelConfig, {}, device="cpu").run()
    assert run.hyperopt is False and len(calls) == 1
    assert not os.path.isdir(tmp_path / "log")
