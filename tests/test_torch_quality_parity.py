"""The port's trained quality against the JAX package's, on the CPU.

(a) The port's copy of JAX's synthetic generator writes files byte-equal to
``skrx.io.synthetic.make_dataset_dir``'s for the same arguments.
(b) ``fit()`` of both packages on the same files: BPRMF, LightGCN and
MultVAE at ``tests/test_quality_parity.py``'s size (120 users, 200 items,
3,500 ratings, latent structure), 15 epochs. The port's best NDCG@10 and
its Recall@10 lie within a band of JAX's at the same run seed. The band,
``max(2 r, 0.05 mu)``, comes from JAX's best at run seeds 2021-2023 (mean
mu, range r), measured before the port was run at this configuration; the
three values of each are kept below. Controls: Pop, and a BPRMF that never
trained, on the same files fall outside every band.
"""
import filecmp
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from skrx import RunConfig as JaxRunConfig
from skrx.io import synthetic as jsyn
from skrx.utils import ModelRegistry as JaxRegistry
from skrx_torch import RunConfig
from skrx_torch.io import synthetic as tsyn
from skrx_torch.utils import ModelRegistry

SIZE = dict(num_users=120, num_items=200, num_ratings=3500, seed=13,
            latent_dim=4, latent_strength=8.0)
EPOCHS = 15
SEED = 2021
MODELS = {
    "BPRMF": dict(lr=0.01, reg=0.01, n_dim=16, batch_size=256),
    "LightGCN": dict(lr=0.01, reg=1e-3, embed_size=16, n_layers=2,
                     batch_size=256),
    "MultVAE": dict(lr=0.005, p_dims=[16], batch_size=32),
}
# JAX's best (by NDCG@10) at run seeds 2021, 2022, 2023 on these data
JAX_SEEDS = {
    "BPRMF": {"NDCG@10": (0.2858928442001343, 0.2477431744337082,
                          0.30353957414627075),
              "Recall@10": (0.389932781457901, 0.333229660987854,
                            0.4057021141052246)},
    "LightGCN": {"NDCG@10": (0.2722620666027069, 0.2638263702392578,
                             0.28652656078338623),
                 "Recall@10": (0.4011833369731903, 0.3714750409126282,
                               0.3987809121608734)},
    "MultVAE": {"NDCG@10": (0.19539913535118103, 0.17359213531017303,
                            0.18643943965435028),
                "Recall@10": (0.2744244337081909, 0.2621121108531952,
                              0.27082082629203796)},
}


# models that learn nothing of the data's user-item structure: the
# popularity ranking, and BPRMF at its initial weights
CONTROLS = {"Pop": ({}, 0), "BPRMF": (MODELS["BPRMF"], 0)}


def band(values) -> float:
    mu = float(np.mean(values))
    return max(2 * (max(values) - min(values)), 0.05 * mu)


@pytest.mark.parametrize("args", [
    dict(SIZE, with_mm=True),
    dict(SIZE, split="leave_out"),
    dict(SIZE, columns="UI"),
    dict(SIZE, seed=5, latent_dim=3, split="leave_out", by_time=False,
         columns="UIT"),
], ids=["with_mm", "leave_out", "UI", "leave_out_random_UIT"])
def test_generator_files_equal_jax_byte_for_byte(tmp_path, args):
    out = {}
    for tag, mod in (("jax", jsyn), ("torch", tsyn)):
        np.random.seed(7)            # the random splits' global draws
        out[tag] = mod.make_dataset_dir(str(tmp_path / tag), **args)
    names = sorted(os.listdir(out["jax"]))
    assert names == sorted(os.listdir(out["torch"]))
    if args.get("with_mm"):
        assert any(n.endswith(".img.npz") for n in names)
    for name in names:
        assert filecmp.cmp(os.path.join(out["jax"], name),
                           os.path.join(out["torch"], name),
                           shallow=False), name


def test_catalog_generator_files_unchanged(tmp_path):
    """Without ``latent_dim`` the catalog-scale generator writes the files
    it wrote before JAX's generator joined it (their md5 sums then)."""
    import hashlib
    path = tsyn.make_dataset_dir(str(tmp_path), num_users=300,
                                 num_items=3000, num_ratings=12000, seed=1)
    prefix = os.path.join(path, os.path.basename(path))
    digests = {suffix: hashlib.md5(open(prefix + "." + suffix,
                                        "rb").read()).hexdigest()
               for suffix in ("all", "train", "valid", "test")}
    assert digests == {"all": "11c8be0a922cb9d5e2be8cb1dc5649ab",
                       "train": "7606023ef1d17a4b6bfd2938fbe03890",
                       "valid": "ca6f9d6f24ef0da7aafa147848c9e75f",
                       "test": "58b329a97a55df3a9c6fd29e47fac68e"}


def test_catalog_generator_refuses_jax_only_options(tmp_path):
    with pytest.raises(ValueError, match="latent_dim"):
        tsyn.make_dataset_dir(str(tmp_path), num_users=30, num_items=40,
                              num_ratings=300, split="leave_out")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("quality")
    return tsyn.make_dataset_dir(str(root), **SIZE)


def _jax_best(name, data):
    reg = JaxRegistry()
    reg.load_skrx_model(name)
    cls, _ = reg.get_model(name)
    run = JaxRunConfig(recommender=name, data_dir=data, file_column="UIRT",
                       sep="\t", metric=("NDCG", "Recall"), top_k=(10,),
                       test_batch_size=64, seed=SEED)
    return cls(run, dict(MODELS[name], epochs=EPOCHS,
                         early_stop=EPOCHS)).fit()


def _torch_model(name, data, hp, epochs):
    reg = ModelRegistry()
    reg.load_skrx_model(name)
    cls, _ = reg.get_model(name)
    run = RunConfig(recommender=name, data_dir=data, file_column="UIRT",
                    sep="\t", metric=("NDCG", "Recall"), top_k=(10,),
                    test_batch_size=64, seed=SEED)
    cfg = dict(hp, epochs=epochs, early_stop=epochs) if hp else {}
    return cls(run, cfg, device="cpu")


def _torch_best(name, data):
    return _torch_model(name, data, MODELS[name], EPOCHS).fit()


@pytest.mark.parametrize("name", list(MODELS))
def test_fit_quality_within_jax_band(name, data, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)             # the models write log/ here
    jax_best = _jax_best(name, data)
    torch_best = _torch_best(name, data)
    for metric in ("NDCG@10", "Recall@10"):
        width = band(JAX_SEEDS[name][metric])
        got, ref = float(torch_best[metric]), float(jax_best[metric])
        assert np.isfinite(got)
        assert abs(got - ref) <= width, (name, metric, got, ref, width)


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("control", list(CONTROLS))
def test_controls_fall_outside_every_band(name, control, data, tmp_path,
                                          monkeypatch):
    """A band that let Pop or an untrained BPRMF in would not tell a model
    that learns from one that does not. Each control's metrics lie outside
    the band around JAX's value at run seed 2021 (the first of
    JAX_SEEDS, which test_fit_quality_within_jax_band's JAX run gives)."""
    monkeypatch.chdir(tmp_path)
    hp, epochs = CONTROLS[control]
    report = _torch_model(control, data, hp, epochs).evaluate()
    for metric in ("NDCG@10", "Recall@10"):
        width = band(JAX_SEEDS[name][metric])
        got, ref = float(report[metric]), JAX_SEEDS[name][metric][0]
        assert abs(got - ref) > width, (control, name, metric, got, ref,
                                        width)
