"""Every model config of the port against the JAX package's: the same
fields and defaults (the TPU-only ``max_scan_steps`` set aside), the same
search grid and combination count; the base ``ModelConfig``'s empty grid;
``RunConfig``'s fields and defaults."""
import importlib
import os

import pytest

pytest.importorskip("jax")

from skrx import RunConfig as JaxRunConfig
from skrx.utils import ModelConfig as JaxModelConfig
from skrx_torch import ModelConfig, RunConfig

MODELS = sorted(
    f[:-3] for f in os.listdir(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "skrx_torch", "models")) if f[:1].isupper() and f.endswith(".py"))


def _configs(name):
    return tuple(getattr(importlib.import_module(f"{pkg}.models.{name}"),
                         name + "Config") for pkg in ("skrx", "skrx_torch"))


def test_the_port_has_every_model():
    assert len(MODELS) == 26
    jax_models = sorted(
        f[:-3] for f in os.listdir(os.path.dirname(
            importlib.import_module("skrx.models").__file__))
        if f[:1].isupper() and f.endswith(".py"))
    assert MODELS == jax_models


@pytest.mark.parametrize("name", MODELS)
def test_defaults_and_grid_equal_jax(name):
    jcls, tcls = _configs(name)
    jd = dict(jcls().to_dict())
    jd.pop("max_scan_steps", None)
    assert dict(tcls().to_dict()) == jd
    assert tcls.param_space() == jcls.param_space()
    assert tcls.num_combos() == jcls.num_combos()
    assert issubclass(tcls, ModelConfig)


def test_bprmf_grid_and_base_config():
    from skrx_torch.models.BPRMF import BPRMFConfig
    assert BPRMFConfig.param_space() == {
        "lr": [0.001, 0.005, 0.01, 0.05],
        "reg": [0.0, 0.001, 0.005, 0.01, 0.05]}
    assert BPRMFConfig.num_combos() == 20
    assert ModelConfig.param_space() == JaxModelConfig.param_space() == {}
    assert ModelConfig.num_combos() == JaxModelConfig.num_combos() == 1

    class Grid(ModelConfig):
        @classmethod
        def param_space(cls):
            return {"a": [1, 2, 3], "b": [], "c": [0, 1]}
    assert Grid.num_combos() == 6


def test_run_config_fields_and_defaults_equal_jax():
    jd, td = dict(JaxRunConfig().to_dict()), dict(RunConfig().to_dict())
    assert set(td) == set(jd)
    assert td == jd
    for key in ("hyperopt", "compute_dtype", "mesh_shape"):
        assert key in td
