"""Rules of the PyTorch port: it imports no JAX, no skrx and no pandas,
triton only inside functions, and its entry points default to CUDA and
raise without it."""
import ast
import os
import subprocess
import sys
import types

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEVER = {"jax", "jaxlib", "skrx", "pandas"}


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "skrx_torch")):
        files += [os.path.join(dirpath, f) for f in names if f.endswith(".py")]
    return files


def _imports(node, in_function=False):
    """(top-level package, at module level?) of every absolute import."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, ast.Import):
            for alias in child.names:
                yield alias.name.split(".")[0], not in_function
        elif isinstance(child, ast.ImportFrom) and child.level == 0:
            yield child.module.split(".")[0], not in_function
        yield from _imports(child, in_function or isinstance(
            child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)))


def test_port_sources_import_no_jax_skrx_pandas_or_module_level_triton():
    files = _port_files()
    assert len(files) > 15
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for top, at_module_level in _imports(tree):
            assert top not in NEVER, f"{path} imports {top}"
            assert not (top == "triton" and at_module_level), path


def test_importing_every_port_module_pulls_in_no_jax_or_skrx():
    code = (
        "import importlib, pkgutil, sys, skrx_torch\n"
        "for m in pkgutil.walk_packages(skrx_torch.__path__, 'skrx_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'skrx', 'pandas', 'triton')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('skrx_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path,
                                                           monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)            # the model writes log/ here
    from skrx_torch import RunConfig, resolve_device
    from skrx_torch.io import synthetic
    from skrx_torch.models.BPRMF import BPRMF
    from skrx_torch.serve import TopKRecommender

    data = synthetic.make_dataset_dir(str(tmp_path), num_users=20,
                                      num_items=40, num_ratings=200, seed=1)
    run = RunConfig(data_dir=data, gpu_id=0)
    for device in (None, "cuda", "cuda:1"):
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(device)
        with pytest.raises(RuntimeError, match="CUDA"):
            BPRMF(run, {}, device=device)
    model = BPRMF(run, {}, device="cpu")
    assert model.user_emb.device.type == "cpu"
    stub = types.SimpleNamespace(device=torch.device("cuda"),
                                 dataset=model.dataset, num_items=40)
    with pytest.raises(RuntimeError, match="CUDA"):
        TopKRecommender(stub)


def test_fit_and_evaluate_default_to_cuda_and_raise_without_it(tmp_path,
                                                               monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from skrx_torch import ModelRegistry, RunConfig
    from skrx_torch.eval import RankingEvaluator
    from skrx_torch.io import synthetic

    monkeypatch.chdir(tmp_path)
    data = synthetic.make_dataset_dir(str(tmp_path), num_users=20,
                                      num_items=40, num_ratings=200, seed=1)
    reg = ModelRegistry()
    reg.load_skrx_model("BPRMF")
    cls, _ = reg.get_model("BPRMF")
    run = RunConfig(data_dir=data, top_k=(10,), metric=("NDCG",))
    # the model that fit() and evaluate() run on cannot be built on the
    # default device, nor can a bare evaluator
    with pytest.raises(RuntimeError, match="CUDA"):
        cls(run, {"epochs": 1})
    model = cls(run, {"epochs": 1}, device="cpu")
    train = model.dataset.train_data.to_user_dict()
    test = model.dataset.test_data.to_user_dict()
    with pytest.raises(RuntimeError, match="CUDA"):
        RankingEvaluator(train, test, top_k=10)
    assert model.evaluator.device.type == "cpu"
    assert 0.0 <= model.fit()["NDCG@10"] <= 1.0
    assert 0.0 <= model.evaluate()["NDCG@10"] <= 1.0


def test_wrappers_refuse_bad_inputs():
    from skrx_torch.ops.kernels import topk_blocks as ttb
    s = torch.zeros((2, 300))
    with pytest.raises(ValueError):
        ttb.blockwise_topk(s, 5, block_n=100)
    with pytest.raises(ValueError):
        ttb.blockwise_topk(s.double(), 5)
    with pytest.raises(ValueError):
        ttb.blockwise_topk(s, 5, mask_table=torch.zeros((3, 4),
                                                        dtype=torch.int32))
    with pytest.raises(ValueError):
        ttb.pruned_merge(s, torch.zeros((2, 300), dtype=torch.int64), 5,
                         torch.zeros(2))


def test_launch_counts_untouched_by_cpu_path():
    from skrx_torch.ops.kernels import topk_blocks as ttb
    ttb.reset_launches()
    ttb.blockwise_topk(torch.randn(3, 5000), 10)
    assert all(v == 0 for v in ttb.LAUNCHES.values())


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k,block_n,width", [
    (64, 40981, 10, 4096, 300),            # the serving shape
    (3, 130, 1, 128, 4),                   # one ragged block
    (9, 5000, 128, 4096, 0),               # wide k, no mask
    (5, 8192, 50, 4096, 8192),             # fully masked rows
    (700, 2560, 10, 256, 40),              # many rows, small blocks
])
def test_cuda_kernels_match_plain_versions(b, n, k, block_n, width):
    """Each kernel against its plain version on CPU copies of the same
    inputs (needs a card; this file imports no JAX, so it runs where JAX is
    absent: ``python -m pytest --noconftest -m cuda
    tests/test_torch_port_rules.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    from skrx_torch.ops.kernels import topk_blocks as ttb
    rng = np.random.default_rng(n + k)
    s = rng.standard_normal((b, n)).astype(np.float32)
    s[1] = np.round(s[1])                  # ties
    s[-1] = 0.0                            # tie storm: every block full
    if b > 2:
        s[2] = -np.inf
    table = rng.integers(-2, n + 2, (b, width)).astype(np.int32)
    if width >= n:
        table[0, :n] = np.arange(n)
    cpu = (torch.from_numpy(s), torch.from_numpy(table) if width else None)
    gpu = tuple(None if x is None else x.cuda() for x in cpu)
    ttb.reset_launches()
    v, i, tau = ttb.blockwise_candidates(gpu[0], k, block_n, gpu[1])
    rv, ri, rtau = ttb.blockwise_candidates(cpu[0], k, block_n, cpu[1])
    assert torch.equal(tau.cpu().view(torch.int32), rtau.view(torch.int32))
    assert torch.equal(v.cpu(), rv) and torch.equal(i.cpu(), ri)
    mv, mi = ttb.pruned_merge(v, i, k, tau)
    rmv, rmi = ttb.pruned_merge(rv, ri, k, rtau)
    assert torch.equal(mv.cpu(), rmv) and torch.equal(mi.cpu(), rmi)
    vv, vi = ttb.vmem_topk(v, i, k)
    assert torch.equal(vv.cpu(), rmv) and torch.equal(vi.cpu(), rmi)
    torch.cuda.synchronize()
    assert ttb.LAUNCHES == {"submax": 1, "kth_largest": 1, "extract": 1,
                            "pruned_merge": 2, "rank_count": 0,
                            "direct_rank": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k,t,width", [
    (64, 40981, 50, 424, 1472),            # the evaluation shape, Gowalla
    (64, 3706, 50, 464, 2600),             # the evaluation shape, ML-1M
    (7, 51000, 200, 1, 300),               # one probe, a row of 25 tiles
    (9, 5000, 10, 130, 0),                 # T > 128, no mask
    (5, 2100, 5, 40, 2100),                # fully masked rows
])
def test_cuda_rank_kernels_match_plain_versions(b, n, k, t, width):
    """rank_count and direct_rank against their plain versions on CPU
    copies of the same inputs: ties, masked, out-of-range, duplicated,
    -inf and +inf probes (needs a card, as the sweep above)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    from skrx_torch.ops.kernels import topk_blocks as ttb
    rng = np.random.default_rng(n + t)
    s = rng.standard_normal((b, n)).astype(np.float32)
    s[1] = np.round(s[1])                  # tie storm
    s[2, ::3] = -np.inf
    s[3, 5] = np.inf
    table = rng.integers(-2, n + 2, (b, width)).astype(np.int32)
    if width >= n:
        table[0, :n] = np.arange(n)
    probes = rng.integers(-3, n + 3, (b, t)).astype(np.int32)
    probes[:, : t // 2] = probes[:, :1]    # duplicates
    probes[3, 0] = 5                       # the +inf column
    if width and t > 4:
        probes[:, 1:4] = table[:, :3]      # masked probes
    cpu = [torch.from_numpy(x) for x in (s, table, probes)]
    gpu = [x.cuda() for x in cpu]
    mask_c, mask_g = (cpu[1], gpu[1]) if width else (None, None)
    ttb.reset_launches()
    got = ttb.direct_rank(gpu[0], gpu[2], k, mask_g)
    assert torch.equal(got.cpu(), ttb.direct_rank_plain(cpu[0], mask_c,
                                                        cpu[2], k))
    if n // 128 >= k:
        cand_v, cand_i, _ = ttb.blockwise_candidates(gpu[0], k, 4096, mask_g)
        st = gpu[0].gather(1, gpu[2].clamp(0, n - 1).long())
        got = ttb.rank_count(cand_v, cand_i, st, gpu[2])
        ref = ttb.rank_count_plain(cand_v.cpu(), cand_i.cpu(), st.cpu(),
                                   cpu[2])
        assert torch.equal(got.cpu(), ref)
        ranks = ttb.masked_topk_ranks(gpu[0], k, gpu[2], mask_g)
        small = ttb.direct_rank_plain(cpu[0], mask_c, cpu[2], k)
        assert torch.equal(ranks.cpu().clamp(max=k), small.clamp(max=k))
    torch.cuda.synchronize()
    assert ttb.LAUNCHES["direct_rank"] == 1
    assert ttb.LAUNCHES["rank_count"] == (2 if n // 128 >= k else 0)
