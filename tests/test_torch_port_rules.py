"""Rules of the PyTorch port: it imports no JAX, no skrx and no pandas,
triton only inside functions, and its entry points default to CUDA and
raise without it."""
import ast
import importlib.util
import os
import subprocess
import sys
import types

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEVER = {"jax", "jaxlib", "skrx", "pandas"}


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "chip_ab.py"),
             os.path.join(ROOT, "run_skrx_torch.py"),
             os.path.join(ROOT, "experiments", "segsum_merge_variants.py"),
             os.path.join(ROOT, "experiments", "rank_count_designs.py"),
             os.path.join(ROOT, "experiments", "submax_variants.py"),
             os.path.join(ROOT, "experiments", "direct_rank_designs.py"),
             os.path.join(ROOT, "experiments", "dedup_rows_designs.py"),
             os.path.join(ROOT, "experiments", "ordered_row_sum_designs.py"),
             os.path.join(ROOT, "experiments", "chip_phase9.py"),
             os.path.join(ROOT, "experiments", "determinism_scan.py"),
             os.path.join(ROOT, "experiments", "epoch_times.py"),
             os.path.join(ROOT, "experiments", "chip_phase12.py"),
             os.path.join(ROOT, "experiments", "chip_phase13.py"),
             os.path.join(ROOT, "experiments", "chip_phase14.py"),
             os.path.join(ROOT, "experiments", "chip_phase15.py"),
             os.path.join(ROOT, "experiments", "chip_phase16.py"),
             os.path.join(ROOT, "experiments", "chip_phase17.py"),
             os.path.join(ROOT, "experiments", "chip_phase18.py"),
             os.path.join(ROOT, "scripts", "longrun_torch.py"),
             os.path.join(ROOT, "examples", "run_synthetic_torch.py")]
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
        "import importlib, pkgutil, subprocess, sys, skrx_torch\n"
        "def no_nvcc(*a, **k): raise AssertionError('nvcc at import')\n"
        "subprocess.Popen = no_nvcc\n"
        "for m in pkgutil.walk_packages(skrx_torch.__path__, 'skrx_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'skrx', 'pandas', 'triton')]\n"
        "assert not bad, bad\n"
        "from skrx_torch.ops.kernels import _build\n"
        "assert not _build._libs and not _build._info\n"
        "print(len([m for m in sys.modules if m.startswith('skrx_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


# the float index_add calls the port keeps, by (file under skrx_torch/,
# enclosing function), each with its reason; on a card index_add adds
# through atomics in no fixed order, so any other sum of the train path
# goes through skrx_torch.ops.scatter
INDEX_ADD_KEPT = {
    # the plain versions of kernel #11 and its merge pass: CPU-only
    # contracts, where index_add_ is a serial loop
    ("ops/kernels/segsum.py", "segsum_plain"): "plain kernel version",
    ("ops/kernels/segsum.py", "segsum_merge_plain"): "plain kernel version",
    # the ordered sum itself on CPU tensors, serial in batch order there
    ("ops/scatter.py", "ordered_row_sum"): "CPU branch, batch order",
    # 0/1 counts: exact in f32 whatever the order
    ("models/LayerGCN.py", "layergcn_mask_from_keep"): "exact counts",
    # kNN graph normalisers taken once when the graph is built, cached
    ("ops/mm_graph.py", "weighted_knn_edges"): "build time, cached",
    ("ops/mm_graph.py", "lattice_original_edges"): "build time, cached",
}


def _index_add_calls(tree):
    """(enclosing function, line) of every ``.index_add``/``index_add_``
    call and ``torch.index_add`` in a module's tree."""
    def walk(node, func):
        for child in ast.iter_child_nodes(node):
            inner = child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func
            if isinstance(child, ast.Call) and isinstance(
                    child.func, ast.Attribute) and child.func.attr in (
                    "index_add", "index_add_"):
                yield func, child.lineno
            yield from walk(child, inner)
    yield from walk(tree, None)


def test_no_unordered_index_add_outside_the_named_exceptions():
    """Every index_add under skrx_torch/ is one of INDEX_ADD_KEPT, and
    every entry there still has its call: a new sum in no fixed order
    fails here, on the CPU, not on the card."""
    pkg = os.path.join(ROOT, "skrx_torch")
    found = set()
    for dirpath, _, names in os.walk(pkg):
        for name in names:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, pkg).replace(os.sep, "/")
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for func, line in _index_add_calls(tree):
                assert (rel, func) in INDEX_ADD_KEPT, \
                    f"skrx_torch/{rel}:{line} ({func}) sums by index_add"
                found.add((rel, func))
    assert found == set(INDEX_ADD_KEPT)


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
    from skrx_torch.models.LightGCN import LightGCN
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            LightGCN(run, {"embed_size": 8}, device=device)
    gcn = LightGCN(run, {"embed_size": 8}, device="cpu")
    assert gcn.user_emb.device.type == gcn.graph.fwd.src.device.type == "cpu"
    stub = types.SimpleNamespace(device=torch.device("cuda"),
                                 dataset=model.dataset, num_items=40)
    with pytest.raises(RuntimeError, match="CUDA"):
        TopKRecommender(stub)
    # the command line and the search driver build their models on CUDA
    sys.path.insert(0, ROOT)
    import run_skrx_torch
    from skrx_torch.models.BPRMF import BPRMFConfig
    from skrx_torch.utils.hyperopt_driver import HyperOpt
    with pytest.raises(RuntimeError, match="CUDA"):
        run_skrx_torch.main(["--recommender", "BPRMF", "--data_dir", data])
    for search in (False, True):
        with pytest.raises(RuntimeError, match="CUDA"):
            HyperOpt(RunConfig(data_dir=data, hyperopt=search), BPRMF,
                     BPRMFConfig, {}).run()
    assert run_skrx_torch.main(["--recommender", "Pop", "--data_dir", data],
                               device="cpu")["NDCG@10"] >= 0.0


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
    from skrx_torch.ops.graph import graph_from_coo, propagate
    from skrx_torch.ops.kernels import runtime
    from skrx_torch.ops.kernels import topk_blocks as ttb
    runtime.reset_launches()
    ttb.blockwise_topk(torch.randn(3, 5000), 10)
    from skrx_torch.ops.kernels import dot_topk as tdt
    tdt.dot_topk_ranks(torch.randn(3, 8), torch.randn(700, 8), None, 5,
                       torch.zeros((3, 4), dtype=torch.int32), block_n=256)
    x = torch.randn(4, 8, requires_grad=True)
    propagate(graph_from_coo([0, 1, 2], [1, 2, 3], [1.0, 1.0, 1.0], 4),
              x).sum().backward()
    assert set(runtime.LAUNCHES) == set(runtime.KERNELS)
    assert all(v == 0 for v in runtime.LAUNCHES.values())


def test_ctypes_signatures_match_the_c_launchers():
    """Every C launcher in csrc/ has a signature in runtime, argument for
    argument (pointers and the stream as c_void_p, ints as c_int), and
    launch() types the stream too: an untyped stream argument is passed as
    a 32-bit int."""
    import ctypes
    import glob
    import re
    from skrx_torch.ops.kernels import runtime
    found = {}
    for path in glob.glob(os.path.join(ROOT, "skrx_torch", "ops", "kernels",
                                       "csrc", "*.cu")):
        with open(path) as f:
            text = f.read()
        stem = os.path.splitext(os.path.basename(path))[0]
        for name, params in re.findall(r"^int (skrx_\w+)\(([^)]*)\)", text,
                                       re.M):
            if name.endswith("_abi_version"):
                continue
            found[name] = (stem, [
                ctypes.c_void_p if "*" in p or "cudaStream_t" in p
                else ctypes.c_int for p in params.split(",")])
    assert found and set(found) == set(runtime._SIGNATURES)
    for name, (stem, types_) in found.items():
        assert runtime._SIGNATURES[name][0] == stem
        assert runtime._SIGNATURES[name][1] + [ctypes.c_void_p] == types_, name


@pytest.mark.parametrize("name,stem,n_args", [
    ("skrx_rank_lookup_count", "rank_counts", 8),
    ("skrx_dot_submax", "dot_topk", 11),
    ("skrx_dot_extract", "dot_topk", 14),
])
def test_fused_route_launchers_have_typed_signatures(name, stem, n_args):
    """The launchers of kernels #7, #9 and #10: every argument before the
    stream typed, pointers as c_void_p (the test above holds them to the C
    declarations)."""
    import ctypes
    from skrx_torch.ops.kernels import runtime
    got_stem, argtypes = runtime._SIGNATURES[name]
    assert got_stem == stem and len(argtypes) == n_args
    assert set(argtypes) <= {ctypes.c_void_p, ctypes.c_int}
    assert argtypes[0] is ctypes.c_void_p and argtypes[-1] is ctypes.c_void_p


def test_launch_types_every_argument_and_raises_on_a_cuda_error(
        monkeypatch):
    import contextlib
    import ctypes
    from skrx_torch.ops.kernels import _build, runtime
    calls = []

    def fn(*args):
        calls.append(args)
        return 700 if len(calls) > 1 else 0
    monkeypatch.setattr(_build, "load", lambda stem: types.SimpleNamespace(
        skrx_segsum=fn))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    t = torch.zeros(3, 4)
    args = (t, 4, t, t, 3, t, t, t, None, 1, t, t, t, t, t, t)
    runtime.launch("skrx_segsum", "cuda", *args)
    P, I = ctypes.c_void_p, ctypes.c_int
    assert fn.argtypes == [P, I, P, P, I, P, P, P, P, I, P, P, P, P, P, P, P]
    assert calls[0] == tuple(a.data_ptr() if isinstance(a, torch.Tensor)
                             else a for a in args) + (0,)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        runtime.launch("skrx_segsum", "cuda", *args)


def test_segsum_on_a_cuda_tensor_never_reaches_the_plain_version(
        monkeypatch):
    """With the device check answering 'cuda', segsum goes to one launch
    that also merges the rows of several segments (the Segments' merge
    table and counters passed; null pointers for a graph without such
    rows), and a failed launch raises instead of falling back."""
    from skrx_torch.ops.graph import graph_from_coo
    from skrx_torch.ops.kernels import runtime
    from skrx_torch.ops.kernels import segsum as ss

    def plain(*args, **kwargs):
        raise AssertionError("plain version reached")

    calls = []
    monkeypatch.setattr(ss, "on_cuda", lambda *t: True)
    monkeypatch.setattr(ss, "segsum_plain", plain)
    monkeypatch.setattr(ss, "segsum_merge_plain", plain)
    monkeypatch.setattr(ss, "launch", lambda name, dev, *a: calls.append(
        (name, a)))
    hub = 2 * ss.SEGMENT_EDGES + 1
    g = graph_from_coo(list(range(hub)), [0] * hub, [1.0] * hub, 2,
                       num_src_nodes=hub)
    runtime.reset_launches()
    mask = torch.ones(hub)
    ss.segsum(g.fwd, torch.zeros((hub, 64)), mask, torch.bfloat16)
    assert [c[0] for c in calls] == ["skrx_segsum"]
    assert calls[0][1][8] is mask and calls[0][1][9] == 1     # mask, bf16
    merge = calls[0][1][12:]
    assert all(a is b for a, b in zip(merge, (
        g.fwd.part_merge, g.fwd.merge_row, g.fwd.merge_ptr,
        g.fwd.merge_count))) and len(merge) == 4
    assert calls[0][1][11].shape == (3, 64)                  # partial rows
    assert runtime.LAUNCHES["segsum"] == 1
    # the backward direction has no row of several segments
    ss.segsum(g.bwd, torch.zeros((2, 64)))
    assert calls[1][0] == "skrx_segsum" and calls[1][1][12:] == (None,) * 4
    assert runtime.LAUNCHES["segsum"] == 2

    def failed(name, dev, *a):
        raise RuntimeError(f"{name} launch failed: CUDA error 1")
    monkeypatch.setattr(ss, "launch", failed)
    with pytest.raises(RuntimeError, match="launch failed"):
        ss.segsum(g.fwd, torch.zeros((hub, 64)))


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
    from skrx_torch.ops.kernels import runtime
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
    runtime.reset_launches()
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
    assert runtime.LAUNCHES == {"submax": 1, "kth_largest": 1, "extract": 1,
                                "pruned_merge": 1, "vmem_topk": 1,
                                "rank_count": 0,
                                "rank_lookup_count": 0, "direct_rank": 0,
                                "dot_submax": 0, "dot_extract": 0,
                                "segsum": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k,t,width,nan", [
    pytest.param(64, 40981, 50, 424, 1472, False,
                 id="64-40981-50-424-1472"),    # the evaluation shape, Gowalla
    pytest.param(64, 3706, 50, 464, 2600, False,
                 id="64-3706-50-464-2600"),     # the evaluation shape, ML-1M
    pytest.param(7, 51000, 200, 1, 300, False,
                 id="7-51000-200-1-300"),       # one probe, a wide row
    pytest.param(9, 5000, 10, 130, 0, False,
                 id="9-5000-10-130-0"),         # T > 128, no mask
    pytest.param(5, 2100, 5, 40, 2100, False,
                 id="5-2100-5-40-2100"),        # fully masked rows
    (64, 3706, 50, 488, 1712, True),            # ML-1M with NaN scores
    (5, 70001, 600, 600, 300, False),           # two bitmap windows, slices
])
def test_cuda_rank_kernels_match_plain_versions(b, n, k, t, width, nan):
    """rank_count and direct_rank against their plain versions on CPU
    copies of the same inputs: ties, masked, out-of-range, duplicated,
    -inf and +inf probes, and NaN scores, some at probes' ids (needs a
    card, as the sweep above)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    from skrx_torch.ops.kernels import runtime
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
    if nan:
        s[:, 7::13] = np.nan
        probes[:, 4:8] = (7, 8, 20, 21)    # NaN ids and their neighbours
    cpu = [torch.from_numpy(x) for x in (s, table, probes)]
    gpu = [x.cuda() for x in cpu]
    mask_c, mask_g = (cpu[1], gpu[1]) if width else (None, None)
    runtime.reset_launches()
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
    assert runtime.LAUNCHES["direct_rank"] == 1
    assert runtime.LAUNCHES["rank_count"] == (2 if n // 128 >= k else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,k,width,kind", [
    (1024, 40981, 64, 10, 1472, "normal"),     # the serving shape
    (64, 40981, 64, 50, 1472, "normal"),       # the evaluation shape
    (40, 9000, 8, 50, 30, "no bias"),
    (9, 4200, 60, 20, 0, "normal"),            # no mask, d not a power of 2
    (33, 5000, 512, 10, 40, "normal"),         # the widest d
    (64, 12288, 16, 50, 6, "tie storm"),       # whole blocks equal
    (6, 8192, 16, 10, 8192, "masked rows"),    # fully masked, < k unmasked
    (5, 300, 16, 200, 10, "duplicated"),       # n_sub < k: tau = -inf
])
def test_cuda_fused_kernels_match_plain_versions(b, n, d, k, width, kind):
    """dot_submax, dot_extract and rank_lookup_count against their plain
    versions on CPU copies of the same inputs, bit for bit (needs a card,
    as the sweeps above)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    from skrx_torch.ops.kernels import dot_topk as tdt
    from skrx_torch.ops.kernels import runtime
    from skrx_torch.ops.kernels import topk_blocks as ttb
    rng = np.random.default_rng(n + d)
    uv = rng.standard_normal((b, d)).astype(np.float32)
    items = rng.standard_normal((n, d)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    if kind == "tie storm":
        uv[:], bias[:] = 0.0, 0.25
    if kind == "duplicated":
        items[n // 2:] = items[: n - n // 2]
    table = rng.integers(-2, n + 2, (b, width)).astype(np.int32)
    if kind == "masked rows":
        table[0] = np.arange(n)
        table[1, : n - 4] = np.arange(n - 4)
    cpu = [torch.from_numpy(x) for x in (uv, items, bias, table)]
    gpu = [x.cuda() for x in cpu]
    bias_c, bias_g = (None, None) if kind == "no bias" else (cpu[2], gpu[2])
    mask_c, mask_g = (cpu[3], gpu[3]) if width else (None, None)
    pc, pg = tdt.pack_items(cpu[1], bias_c), tdt.pack_items(gpu[1], bias_g)
    runtime.reset_launches()
    bm = tdt.dot_submax(gpu[0], pg, mask_g)
    assert torch.equal(bm.cpu(), tdt.dot_submax_plain(cpu[0], pc, mask_c))
    v, i, tau = tdt.dot_topk_candidates(gpu[0], None, None, k, mask_g,
                                        packed=pg)
    rv, ri = tdt.dot_extract_plain(cpu[0], pc, mask_c, tau.cpu(), k)
    assert torch.equal(v.cpu(), rv) and torch.equal(i.cpu(), ri)
    probes = rng.integers(-3, n + 3, (b, 300)).astype(np.int32)
    probes[:, :10] = ri[:, :10].numpy()
    probes[:, 10:14] = probes[:, :1]               # duplicated
    got = ttb.rank_lookup_count(v, i, torch.from_numpy(probes).cuda())
    ref = ttb.rank_lookup_count_plain(rv, ri, torch.from_numpy(probes))
    assert all(torch.equal(g.cpu(), r) for g, r in zip(got, ref))
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["dot_submax"] == 2
    assert runtime.LAUNCHES["dot_extract"] == 1
    assert runtime.LAUNCHES["rank_lookup_count"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("w", [128, 256, 1408, 4096, 5000])
def test_cuda_kth_largest_matches_plain_version(w):
    """kth_largest at the widths of its register instantiations and past
    them (5,000: the row read each round), k in {1, 10, 50, W}, against its
    plain version on a CPU copy, bit for bit: ties across the k-th place,
    all -inf rows, signed zeros and subnormals, negatives only, fewer than
    k finite entries, +inf (needs a card, as the sweeps above)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    from skrx_torch.ops.kernels import runtime
    from skrx_torch.ops.kernels import topk_blocks as ttb
    x = _chip_smoke().kth_rows(np.random.default_rng(w), w)
    ks = sorted({1, min(10, w), min(50, w), w})
    runtime.reset_launches()
    for k in ks:
        got = ttb.kth_largest(torch.from_numpy(x).cuda(), k)
        ref = ttb.kth_largest_plain(torch.from_numpy(x), k)
        assert torch.equal(got.cpu().view(torch.int32), ref.view(torch.int32))
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["kth_largest"] == len(ks)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 50])
def test_cuda_extract_matches_plain_version_at_survivor_boundaries(k):
    """extract where a block holds 0, 1, 31, 32, 33, k - 1, k, k + 1, F and
    F + 1 survivors (F: the most it ranks directly), a block whose every
    column equals tau, and +-0.0 ties, against its plain version on CPU
    copies: values as int32 and ids equal (needs a card, as above)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    from skrx_torch.ops.kernels import runtime
    from skrx_torch.ops.kernels import topk_blocks as ttb
    s, mask, tau, _ = _chip_smoke().extract_rows(np.random.default_rng(k), k)
    cpu = [torch.from_numpy(x) for x in (s, mask, tau)]
    runtime.reset_launches()
    v, i = ttb.extract(cpu[0].cuda(), cpu[2].cuda(), k, cpu[1].cuda())
    rv, ri = ttb.extract_plain(cpu[0], cpu[1], cpu[2], k, 4096)
    assert torch.equal(v.cpu().view(torch.int32), rv.view(torch.int32))
    assert torch.equal(i.cpu(), ri)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["extract"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 50])
def test_cuda_pruned_merge_matches_plain_version_at_survivor_boundaries(k):
    """pruned_merge where a row holds 0, 1, 31, 32, 33, k - 1, k, k + 1, F
    and F + 1 survivors (F: the most it ranks directly), repeated pairs
    with +-0.0 on both sides of F, NaN candidates, and vmem_topk on the
    chunked evaluation's merge (a chunk of 8,192 items and the last 21),
    against pruned_merge_plain on CPU copies: values as int32 and ids equal
    (needs a card, as above)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    from skrx_torch.ops.kernels import runtime
    from skrx_torch.ops.kernels import topk_blocks as ttb
    smoke = _chip_smoke()
    rng = np.random.default_rng(k)
    vals, ids, tau, _ = smoke.merge_rows(rng, k)
    cases = [(vals, ids, tau)] + [
        smoke.chunk_rows(rng, k, chunk_w) + (np.full(4, -np.inf, np.float32),)
        for chunk_w in (8192, 21)]
    runtime.reset_launches()
    for vals, ids, tau in cases:
        cpu = [torch.from_numpy(x) for x in (vals, ids, tau)]
        v, i = ttb.pruned_merge(cpu[0].cuda(), cpu[1].cuda(), k, cpu[2].cuda())
        rv, ri = ttb.pruned_merge_plain(cpu[0], cpu[1], k, cpu[2])
        assert torch.equal(v.cpu().view(torch.int32), rv.view(torch.int32))
        assert torch.equal(i.cpu(), ri)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["pruned_merge"] == len(cases)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [37, 2349])
@pytest.mark.parametrize("t", [1, 129, 416])
def test_cuda_rank_count_matches_plain_version_on_adversarial_keys(w, t):
    """rank_count on +-0.0 ties between probe and candidate, NaN candidates
    and probes, -inf candidates with the sentinel id against -inf probes,
    negative ids and probes equal to a candidate pair, W not a multiple of
    any tile, against rank_count_plain on CPU copies (needs a card, as
    above)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    from skrx_torch.ops.kernels import runtime
    from skrx_torch.ops.kernels import topk_blocks as ttb
    rows = _chip_smoke().rank_rows(np.random.default_rng(w + t), w, t)
    cpu = [torch.from_numpy(x) for x in rows]
    runtime.reset_launches()
    got = ttb.rank_count(*(x.cuda() for x in cpu))
    assert torch.equal(got.cpu(), ttb.rank_count_plain(*cpu))
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["rank_count"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [40_981, 1000])
@pytest.mark.parametrize("block_n", [4096, 256, 128])
def test_cuda_submax_matches_plain_version_on_signed_zeros_and_nan(n,
                                                                   block_n):
    """submax on groups of +0.0 before -0.0, -0.0 before +0.0, -0.0 only,
    NaN of either sign, +inf beside NaN and a fully masked row, with and
    without the mask table (a last block of 21 columns at N = 40,981 and
    block_n 4,096), against submax_plain on CPU copies: the int32 views
    equal, NaN by isnan (needs a card, as above)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    from skrx_torch.ops.kernels import runtime
    from skrx_torch.ops.kernels import topk_blocks as ttb
    smoke = _chip_smoke()
    s, mask = (torch.from_numpy(x) for x in smoke.submax_rows(
        np.random.default_rng(n + block_n), n, block_n))
    runtime.reset_launches()
    for m in (mask, None):
        got = ttb.submax(s.cuda(), None if m is None else m.cuda(), block_n)
        assert smoke.same_bits(got, ttb.submax_plain(s, m, block_n))
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["submax"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("w", [37, 550, 2049, 5000])
@pytest.mark.parametrize("t", [1, 129, 416])
def test_cuda_rank_lookup_count_matches_plain_version_on_adversarial_rows(
        w, t):
    """rank_lookup_count on ids repeated with NaN, -inf and finite copies,
    rows of extract's empty slots, a row with no -inf lane, probes equal to
    the sentinel, out of range and duplicated, W up to three tiles, against
    rank_lookup_count_plain on CPU copies (needs a card, as above)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    from skrx_torch.ops.kernels import runtime
    from skrx_torch.ops.kernels import topk_blocks as ttb
    rows = _chip_smoke().lookup_rows(np.random.default_rng(w + t), w, t)
    cpu = [torch.from_numpy(x) for x in rows]
    runtime.reset_launches()
    ranks, found = ttb.rank_lookup_count(*(x.cuda() for x in cpu))
    ref_r, ref_f = ttb.rank_lookup_count_plain(*cpu)
    assert torch.equal(ranks.cpu(), ref_r) and torch.equal(found.cpu(), ref_f)
    assert found.dtype == torch.bool
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["rank_lookup_count"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("msg", ["f32", "bf16"])
def test_cuda_segsum_merges_the_same_rows_in_every_launch(msg):
    """One Segments launched three times in a row gives the same bits each
    time and leaves every arrival counter at 0; the graph puts many rows of
    several segments into one thread block (rows of 2 to 4 segments side
    by side) beside a hub of 40 segments (needs a card, as above)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    from skrx_torch.ops.graph import graph_from_coo
    from skrx_torch.ops.kernels import segsum as ss
    rng = np.random.default_rng(5)
    deg = np.concatenate([rng.integers(129, 4 * 128 + 1, 30), [40 * 128],
                          rng.integers(0, 50, 30)])
    dst = np.repeat(np.arange(len(deg)), deg)
    src = rng.integers(0, 900, len(dst))
    g = graph_from_coo(src, dst, rng.random(len(dst)), len(deg),
                       num_src_nodes=900, device="cuda")
    seg = g.fwd
    assert seg.merge_row.shape[0] == 31 and seg.num_partials > 100
    dtype = torch.float32 if msg == "f32" else torch.bfloat16
    x = torch.randn((900, 64), device="cuda")
    outs = [ss.segsum(seg, x, None, dtype) for _ in range(3)]
    torch.cuda.synchronize()
    assert not seg.merge_count.any()
    for out in outs[1:]:
        assert torch.equal(out.view(torch.int32), outs[0].view(torch.int32))
    ref = ss.segsum_plain(g.to("cpu").fwd, x.cpu().double(), None, dtype)
    scale = ss.segsum_plain(g.to("cpu").fwd, x.cpu().abs().double(), None,
                            dtype)
    assert bool(((outs[0].cpu().double() - ref).abs()
                 <= 1e-5 * scale + 1e-30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 7, 33])
@pytest.mark.parametrize("d", [8, 60, 64, 128, 512])
def test_cuda_dot_submax_matches_plain_version(b, d):
    """dot_submax where each 4,096-column block is split over a cluster of
    CTAs (B <= 33 over 4 blocks), against its plain version on CPU copies,
    bit for bit: item columns repeated every 512 (equal group maxima in
    every CTA's slice), mask ids in every slice of every block, a fully
    masked row, a zero user vector over a bias with -0.0 (zero maxima are
    +0.0), with and without a bias (needs a card, as the sweeps above)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    from skrx_torch.ops.kernels import dot_topk as tdt
    from skrx_torch.ops.kernels import runtime
    n = 3 * 4096 + 1000
    rng = np.random.default_rng(b * d)
    uv = rng.standard_normal((b, d)).astype(np.float32)
    uv[-1] = 0.0
    items = rng.standard_normal((n, d)).astype(np.float32)
    for lo in range(0, n - 4096, 4096):
        items[lo + 512: lo + 4096] = np.tile(items[lo: lo + 512], (7, 1))
    bias = np.where(rng.random(n) < 0.5, -0.0, 0.0).astype(np.float32)
    table = np.full((b, n), n, np.int32)
    for r in range(b):                                 # 5 ids in each slice
        table[r, :5 * (n // 512)] = (np.arange(n // 512).repeat(5) * 512
                                     + rng.integers(0, 512, 5 * (n // 512)))
    table[0] = np.arange(n)                            # fully masked
    cpu = [torch.from_numpy(x) for x in (uv, items, bias, table)]
    gpu = [x.cuda() for x in cpu]
    runtime.reset_launches()
    for with_bias in (True, False):
        pc = tdt.pack_items(cpu[1], cpu[2] if with_bias else None)
        pg = tdt.pack_items(gpu[1], gpu[2] if with_bias else None)
        for mask_c, mask_g in ((cpu[3], gpu[3]), (None, None)):
            got = tdt.dot_submax(gpu[0], pg, mask_g).cpu()
            ref = tdt.dot_submax_plain(cpu[0], pc, mask_c)
            assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["dot_submax"] == 4


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _segsum_case(case: str, rng):
    """(src, dst, weight, num_nodes, num_src_nodes, nonfinite source rows)
    of one adversarial graph for the segsum kernel."""
    import numpy as np
    if case == "zipf":          # a LightGCN-like bipartite graph with hubs
        users = rng.integers(0, 3000, 60_000)
        items = 3000 + rng.zipf(1.3, 60_000) % 4000
        src = np.concatenate([users, items])
        dst = np.concatenate([items, users])
        return src, dst, rng.random(len(src)), 7000, 7000, []
    if case == "hub":           # one row of 20 x 128 + 3 edges, 90% masked
        e = 20 * 128 + 3
        return (rng.integers(0, 500, e), np.zeros(e, np.int64),
                rng.random(e), 50, 500, [])
    if case == "isolated":      # most rows without edges
        return (rng.integers(0, 400, 300), rng.integers(0, 20, 300) * 17,
                rng.random(300), 400, 400, [])
    if case == "empty":
        return (np.array([], np.int64), np.array([], np.int64),
                np.array([]), 33, 33, [])
    if case == "nonfinite":     # inf/NaN sources behind masked edges
        return (rng.integers(0, 300, 5000), rng.integers(0, 300, 5000),
                rng.random(5000), 300, 300, [3, 77, 150])
    # rectangular: 2,000 sources into 700 rows
    return (rng.integers(0, 2000, 20_000), rng.integers(0, 700, 20_000),
            rng.random(20_000), 700, 2000, [])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["zipf", "hub", "isolated", "empty",
                                  "nonfinite", "rectangular"])
@pytest.mark.parametrize("d", [8, 64, 100, 128])
@pytest.mark.parametrize("msg", ["f32", "bf16"])
def test_cuda_segsum_matches_its_float64_plain_version(case, d, msg):
    """segsum (its merge pass included) on the card against segsum_plain in
    float64 on CPU copies, both directions, with and without an edge mask:
    per row |kernel - ref| <= 1e-5 * sum|msg| (exact zeros where a row has
    no kept edge), every arrival counter back at 0; the gradient of
    propagate likewise. Needs a card, as above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    from skrx_torch.ops.graph import graph_from_coo, propagate
    from skrx_torch.ops.kernels import runtime
    from skrx_torch.ops.kernels import segsum as ss
    rng = np.random.default_rng(d)
    src, dst, w, n, n_src, bad = _segsum_case(case, rng)
    dtype = torch.float32 if msg == "f32" else torch.bfloat16
    g_cpu = graph_from_coo(src, dst, w, n, dtype, num_src_nodes=n_src)
    g = g_cpu.to("cuda")
    mask = torch.from_numpy((rng.random(len(src)) < 0.1 if case == "hub"
                             else rng.random(len(src)) < 0.7)
                            .astype(np.float32) / 0.7)
    for direction, rows_in in (("fwd", n_src), ("bwd", n)):
        seg, seg_cpu = getattr(g, direction), getattr(g_cpu, direction)
        x = torch.from_numpy(rng.standard_normal((rows_in, d))
                             .astype(np.float32))
        if bad and direction == "fwd":
            x[bad] = torch.tensor([float("inf"), float("nan")]).repeat(
                d)[:d]
            cut = np.isin(seg_cpu.src.numpy(), bad)
            mask[torch.from_numpy(seg_cpu.orig.numpy()[cut]).long()] = 0.0
        for m in (None, mask):
            if bad and m is None:
                continue
            runtime.reset_launches()
            got = ss.segsum(seg, x.cuda(), None if m is None else m.cuda(),
                            dtype).cpu().double()
            ref = ss.segsum_plain(seg_cpu, x.double(), m, dtype)
            scale = ss.segsum_plain(
                seg_cpu._replace(weight=seg_cpu.weight.abs()),
                x.abs().double(), m, dtype)
            assert torch.isfinite(got).all()
            err = (got - ref).abs()
            assert bool((err <= 1e-5 * scale + 1e-30).all()), \
                f"{case} {direction}: max err {float(err.max())}"
            assert runtime.LAUNCHES["segsum"] == (1 if seg.num_nodes else 0)
            assert not seg.merge_count.any(), "a counter left set"
    if bad:
        return
    x = torch.from_numpy(rng.standard_normal((n_src, d)).astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    grads = []
    for graph, dev in ((g, "cuda"), (g_cpu, "cpu")):
        xx = x.to(dev).requires_grad_(True)
        (propagate(graph, xx, mask.to(dev)) * ct.to(dev)).sum().backward()
        grads.append(xx.grad.cpu().double())
    scale = float(grads[1].abs().max()) + 1e-30
    assert float((grads[0] - grads[1]).abs().max()) <= 1e-5 * scale
