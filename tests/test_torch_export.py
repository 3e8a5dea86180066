"""The rank tail exported: ``TopKRecommender.export_program`` against the
JAX package's ``export_stablehlo`` on the same scores and seen rows, and the
kernels of the tail (#1-#5) as the operators ``torch.ops.skrx.*``: in an
exported graph, their fake shapes against their CPU outputs, and their CUDA
implementations (launch patched) launching and counting once each with no
way to the plain versions."""
import io
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from skrx import RunConfig as JaxRunConfig
from skrx.io import synthetic as jax_synthetic
from skrx.models.BPRMF import BPRMF as JaxBPRMF
from skrx.ops.pallas import topk_blocks as jtb
from skrx.serve import TopKRecommender as JaxTopKRecommender
from skrx_torch import RunConfig
from skrx_torch.models.BPRMF import BPRMF
from skrx_torch.ops import metrics as tmetrics
from skrx_torch.ops.kernels import operators, runtime
from skrx_torch.ops.kernels import topk_blocks as ttb
from skrx_torch.serve import RankTail, TopKRecommender

TAIL_OPS = ("submax", "kth_largest", "extract", "pruned_merge")
B, K = 4, 5


def _skrx_ops(program) -> list:
    """The ``skrx`` operators an exported program's graph calls, in order."""
    return [n.target.name().split("::")[1].split(".")[0]
            for n in program.graph.nodes if n.op == "call_function"
            and isinstance(n.target, torch._ops.OpOverload)
            and n.target.namespace == "skrx"]


def _round_trip(program):
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return torch.export.load(io.BytesIO(buf.getvalue()))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(jax model, port model) over one dataset with one set of weights."""
    import jax.numpy as jnp
    root = tmp_path_factory.mktemp("torch_export")
    data = jax_synthetic.make_dataset_dir(str(root), num_users=40,
                                          num_items=150, num_ratings=900,
                                          seed=7)
    cwd = os.getcwd()
    os.chdir(root)                         # both models write log/ here
    try:
        jm = JaxBPRMF(JaxRunConfig(recommender="BPRMF", data_dir=data,
                                   seed=1, metric=("NDCG",), top_k=(10,)),
                      dict(n_dim=8))
        tm = BPRMF(RunConfig(data_dir=data, seed=1), dict(n_dim=8),
                   device="cpu")
    finally:
        os.chdir(cwd)
    rng = np.random.default_rng(3)
    jm.params = {
        "user_emb": jnp.asarray(rng.standard_normal(
            (jm.num_users, 8)).astype(np.float32)),
        "item_emb": jnp.asarray(rng.standard_normal(
            (jm.num_items, 8)).astype(np.float32)),
        "item_bias": jnp.asarray(rng.standard_normal(
            jm.num_items).astype(np.float32)),
    }
    tm.load_jax_params({k: np.asarray(v) for k, v in jm.params.items()})
    return jm, tm


@pytest.mark.parametrize("filter_seen", [True, False])
def test_exported_program_matches_jax_export(pair, filter_seen):
    """export_program(4), saved and loaded, against export_stablehlo(4),
    deserialized and called, on one set of distinct scores (no ties, +-0,
    NaN or inf) and the users' seen rows: ids and values equal."""
    from jax import export as jexport
    jm, tm = pair
    j_server = JaxTopKRecommender(jm, k=K, filter_seen=filter_seen)
    t_server = TopKRecommender(tm, k=K, filter_seen=filter_seen)
    blob = t_server.export_program(B)
    assert isinstance(blob, bytes) and len(blob) > 100
    program = torch.export.load(io.BytesIO(blob))
    assert _skrx_ops(program) == []        # the CPU holds the sort route
    j_program = jexport.deserialize(j_server.export_stablehlo(B))

    rng = np.random.default_rng(17 + filter_seen)
    n = tm.num_items
    scores = rng.permutation(n * B).reshape(B, n).astype(np.float32)
    scores = ((scores + 1.0) / (n * B) * rng.choice([-1.0, 1.0], (B, n))
              ).astype(np.float32)
    users = np.array([0, 5, 11, 23])
    seen = t_server._seen[torch.as_tensor(users)]
    np.testing.assert_array_equal(seen.numpy(),
                                  np.asarray(j_server._seen)[users])
    ids, vals = program.module()(torch.from_numpy(scores), seen)
    j_ids, j_vals = j_program.call(scores, seen.numpy())
    assert ids.dtype == torch.int32 and vals.dtype == torch.float32
    assert ids.shape == vals.shape == (B, K)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals))
    # what is exported is what serves: the score route's tail on the same
    # users' predict scores
    s = tm.predict(torch.as_tensor(users)).to(torch.float32)
    r_ids, r_vals = t_server.recommend(users)
    e_ids, e_vals = program.module()(s, seen)
    np.testing.assert_array_equal(r_ids, e_ids.numpy())
    np.testing.assert_array_equal(r_vals, e_vals.numpy())


def test_blockwise_topk_exports_as_the_skrx_operators():
    """blockwise_topk(block_n=256) on CPU tensors exported: the graph calls
    the four operators, and the loaded program equals eager and JAX's
    Pallas kernels in interpret mode."""
    import jax.numpy as jnp

    class Tail(torch.nn.Module):
        def forward(self, scores, mask):
            return ttb.blockwise_topk(scores, K, block_n=256, mask_table=mask)

    rng = np.random.default_rng(5)
    n = 1024
    scores = rng.standard_normal((B, n)).astype(np.float32)
    mask = np.full((B, 40), n, np.int32)
    for r in range(B):
        mask[r, :10 * r] = rng.permutation(n)[:10 * r]
    s_t, m_t = torch.from_numpy(scores), torch.from_numpy(mask)
    program = torch.export.export(Tail(), (s_t, m_t))
    assert _skrx_ops(program) == list(TAIL_OPS)
    loaded = _round_trip(program)
    assert _skrx_ops(loaded) == list(TAIL_OPS)
    vals, ids = loaded.module()(s_t, m_t)
    e_vals, e_ids = Tail()(s_t, m_t)
    j_vals, j_ids = jtb.blockwise_topk(jnp.asarray(scores), K, block_n=256,
                                       interpret=True,
                                       mask_table=jnp.asarray(mask))
    for got in ((e_vals, e_ids), (np.asarray(j_vals), np.asarray(j_ids))):
        np.testing.assert_array_equal(vals.numpy(), np.asarray(got[0]))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(got[1]))


def test_rank_tail_on_a_card_exports_the_kernels():
    """RankTail traced with CUDA-device fake inputs of the serving shape
    (what export_program does on a card) calls the four operators;
    CPU inputs of the same shape take the sort route."""
    n, p = 40_981, 300
    with FakeTensorMode():
        scores = torch.empty((64, n), device="cuda")
        seen = torch.empty((64, p), dtype=torch.int32, device="cuda")
    program = torch.export.export(RankTail(10), (scores, seen))
    assert _skrx_ops(program) == list(TAIL_OPS)
    outs = [n for n in program.graph.nodes if n.op == "output"][0].args[0]
    ids, vals = (o.meta["val"] for o in outs)
    assert (ids.shape, ids.dtype) == ((64, 10), torch.int32)
    assert (vals.shape, vals.dtype) == ((64, 10), torch.float32)
    cpu = torch.export.export(RankTail(10), (
        torch.zeros((2, n)), torch.zeros((2, p), dtype=torch.int32)))
    assert _skrx_ops(cpu) == []


@pytest.mark.parametrize("b,n,k,block_n", [(3, 1000, 5, 256),
                                           (2, 4096, 10, 4096),
                                           (1, 40_981, 10, 4096),
                                           (5, 300, 7, 128),
                                           (4, 640, 128, 128)])
def test_fake_shapes_equal_the_cpu_outputs(b, n, k, block_n):
    """Each operator's fake output on CUDA-device fake tensors has the
    shape and dtype of its output on CPU tensors (N not a multiple of
    block_n included)."""
    rng = np.random.default_rng(b * n + k)
    scores = torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32))
    mask = torch.from_numpy(rng.integers(0, n + 1, (b, 9)).astype(np.int32))
    tau = torch.from_numpy(rng.standard_normal(b).astype(np.float32))
    w = -(-n // block_n) * k
    cand_v = torch.from_numpy(rng.standard_normal((b, w)).astype(np.float32))
    cand_i = torch.from_numpy(rng.integers(0, n, (b, w)).astype(np.int32))
    calls = {
        "submax": lambda s, m, t, cv, ci: torch.ops.skrx.submax(s, m,
                                                                block_n),
        "submax_unmasked": lambda s, m, t, cv, ci: torch.ops.skrx.submax(
            s, None, block_n),
        "kth_largest": lambda s, m, t, cv, ci: torch.ops.skrx.kth_largest(
            cv, k),
        "extract": lambda s, m, t, cv, ci: torch.ops.skrx.extract(
            s, t, k, m, block_n),
        "pruned_merge": lambda s, m, t, cv, ci: torch.ops.skrx.pruned_merge(
            cv, ci, k, t),
        "vmem_topk": lambda s, m, t, cv, ci: torch.ops.skrx.vmem_topk(
            cv, ci, k),
    }
    args = (scores, mask, tau, cand_v, cand_i)
    with FakeTensorMode():
        fakes = [torch.empty(a.shape, dtype=a.dtype, device="cuda")
                 for a in args]
        fake_out = {name: fn(*fakes) for name, fn in calls.items()}
    for name, fn in calls.items():
        real, fake = fn(*args), fake_out[name]
        real = real if isinstance(real, tuple) else (real,)
        fake = fake if isinstance(fake, tuple) else (fake,)
        assert len(real) == len(fake), name
        for r, f in zip(real, fake):
            assert f.device.type == "cuda", name
            assert (tuple(f.shape), f.dtype) == (tuple(r.shape), r.dtype), \
                name


def _no_plain(monkeypatch):
    def plain(*args, **kwargs):
        raise AssertionError("plain version reached")
    for name in ("submax_plain", "kth_largest_plain", "extract_plain",
                 "pruned_merge_plain"):
        monkeypatch.setattr(ttb, name, plain)
        monkeypatch.setattr(operators, name, plain)


def test_cuda_implementations_launch_and_count_once_each(monkeypatch):
    """The operators' "CUDA" kernels, reached by redispatching to that key
    with launch patched: each launches its C launcher once with the
    operands the kernel takes and counts once under its kernel's name
    (vmem_topk's merge as vmem_topk); a failed launch raises."""
    _no_plain(monkeypatch)
    calls = []
    monkeypatch.setattr(operators, "_launch",
                        lambda name, dev, *a: calls.append((name, a)))
    cuda = torch._C.DispatchKeySet(torch._C.DispatchKey.CUDA)
    b, n = 3, 5000
    scores = torch.zeros((b, n))
    mask = torch.zeros((b, 7), dtype=torch.int32)
    tau = torch.zeros(b)
    cv, ci = torch.zeros((b, 20)), torch.zeros((b, 20), dtype=torch.int32)
    runtime.reset_launches()
    sub = torch.ops.skrx.submax.default.redispatch(cuda, scores, mask, 4096)
    kth = torch.ops.skrx.kth_largest.default.redispatch(cuda, sub, 10)
    ev, ei = torch.ops.skrx.extract.default.redispatch(cuda, scores, tau, 10,
                                                       None, 4096)
    mv, mi = torch.ops.skrx.pruned_merge.default.redispatch(cuda, cv, ci, 10,
                                                            tau)
    vv, vi = torch.ops.skrx.vmem_topk.default.redispatch(cuda, cv, ci, 10)
    assert [c[0] for c in calls] == ["skrx_submax", "skrx_kth_largest",
                                     "skrx_extract", "skrx_pruned_merge",
                                     "skrx_pruned_merge"]
    assert sub.shape == (b, 256) and kth.shape == (b,)
    assert ev.shape == ei.shape == (b, 20) and ei.dtype == torch.int32
    assert mv.shape == mi.shape == vv.shape == (b, 10)
    a = calls[0][1]
    assert a[0] is scores and a[1:4] == (b, n, 4096) and a[4] is mask
    assert a[5] == 7 and a[6] is sub
    assert calls[1][1][1:4] == (b, 256, 10)
    assert calls[2][1][4] is None and calls[2][1][5] == 0
    assert calls[3][1][4] is tau and calls[3][1][5] == 10
    assert bool(torch.isneginf(calls[4][1][4]).all())
    assert {k: runtime.LAUNCHES[k] for k in ("submax", "kth_largest",
                                             "extract", "pruned_merge",
                                             "vmem_topk")} == dict.fromkeys(
        ("submax", "kth_largest", "extract", "pruned_merge", "vmem_topk"), 1)
    # no rows: nothing launched or counted
    torch.ops.skrx.submax.default.redispatch(cuda, scores[:0], None, 4096)
    assert len(calls) == 5 and runtime.LAUNCHES["submax"] == 1
    runtime.reset_launches()

    def failed(name, dev, *a):
        raise RuntimeError(f"{name} launch failed: CUDA error 1")
    monkeypatch.setattr(operators, "_launch", failed)
    with pytest.raises(RuntimeError, match="launch failed"):
        torch.ops.skrx.pruned_merge.default.redispatch(cuda, cv, ci, 10, tau)
    assert runtime.LAUNCHES["pruned_merge"] == 0


def test_wrappers_on_a_cuda_tensor_call_only_the_operators(monkeypatch):
    """submax, kth_largest, extract, pruned_merge, vmem_topk and the
    compositions on CUDA-device (fake) tensors reach the kernels only
    through torch.ops.skrx.*, never a plain version, and the wrappers keep
    their checks."""
    from torch.utils._python_dispatch import TorchDispatchMode
    _no_plain(monkeypatch)
    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "skrx":
                seen.append(func.name().split("::")[1].split(".")[0])
            return func(*args, **(kwargs or {}))

    with FakeTensorMode():
        scores = torch.empty((8, 9000), device="cuda")
        mask = torch.empty((8, 6), dtype=torch.int32, device="cuda")
        cv = torch.empty((8, 30), device="cuda")
        ci = torch.empty((8, 30), dtype=torch.int32, device="cuda")
        with Record():
            v, i = ttb.blockwise_topk(scores, 10, mask_table=mask)
            tmetrics.topk_scores_and_indices(scores, 10, mask)
            ttb.vmem_topk(cv, ci, 10)
        assert v.shape == i.shape == (8, 10) and i.dtype == torch.int32
        with pytest.raises(ValueError):
            ttb.pruned_merge(cv, ci, 10, torch.empty(3, device="cuda"))
        with pytest.raises(ValueError):
            ttb.submax(scores, torch.empty((8, 6), dtype=torch.int32))
    assert seen == list(TAIL_OPS) * 2 + ["vmem_topk"]
