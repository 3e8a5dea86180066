"""The port's parallel/ on torch.distributed against the JAX package's
parallel/: the sharded graph's arrays, the sharded propagate through
segsum (#11, its plain version here) with and without an edge mask, and
the two-stage top-k over a split catalog (#1-#5), on 2 gloo ranks on the
CPU. JAX's routes are pinned: the propagate's local ``"mxu"`` kernel and
the top-k's Pallas kernels, both in interpret mode. The ranks are spawned
without JAX: this module imports it only inside the tests."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from skrx_torch.ops.graph import propagate
from skrx_torch.parallel import (ShardedPropGraph, gather_all_rows,
                                 gather_rows, global_batch_from_local,
                                 lookup_rows, make_mesh, model_row_sharding,
                                 pad_rows, run_ranks, sharded_dot_topk,
                                 sharded_graph_from_coo,
                                 sharded_graph_from_sp_matrix, take_rows,
                                 unpad_rows)
from skrx_torch.parallel.mesh import row_blocks

N, D = 37, 8            # 37 rows: no shard count divides them


def _jax():
    jax = pytest.importorskip("jax")
    if len(jax.devices()) < 2:
        pytest.skip("needs the virtual multi-device CPU mesh")
    return jax


def _random_sparse(n, density, seed):
    rng = np.random.default_rng(seed)
    dense = (rng.random((n, n)) < density) * rng.random((n, n))
    return sp.csr_matrix(dense.astype(np.float32))


def _dyadic(rng, shape):
    """Multiples of 1/8 in [-1, 1): their products and short sums are
    exact in f32, so both packages compute the same scores bit for bit."""
    return (rng.integers(-8, 8, shape) / 8).astype(np.float32)


def _inputs():
    rng = np.random.default_rng(5)
    mat = _random_sparse(N, 0.15, 3).tolil()
    mat[5, :] = 0.0
    mat[5, 0] = 0.5                   # row 5 hears only row 0
    mat = mat.tocsr()
    mat.eliminate_zeros()
    coo = sp.coo_matrix(mat)
    mask = ((rng.random(mat.nnz) < 0.7) * 1.25).astype(np.float32)
    x = rng.standard_normal((N, D)).astype(np.float32)
    ct = rng.standard_normal((N, D)).astype(np.float32)
    # row 0 non-finite, every edge out of it masked
    x_bad = x.copy()
    x_bad[0] = np.nan
    mask_bad = mask.copy()
    mask_bad[coo.col == 0] = 0.0
    topk = []
    for n_items, k, b, width in ((37, 36, 6, 4), (1001, 10, 5, 12)):
        topk.append(dict(
            n_items=n_items, k=k, uv=_dyadic(rng, (b, 4)),
            items=_dyadic(rng, (n_items, 4)), bias=_dyadic(rng, n_items),
            # the pad id n_items among the ids, as the evaluator pads
            train=np.concatenate([rng.integers(0, n_items, (b, width - 1)),
                                  np.full((b, 1), n_items)], 1
                                 ).astype(np.int32)))
    rows = dict(table=rng.standard_normal((10, 3)).astype(np.float32),
                ids=rng.integers(0, 10, (2, 7)),
                ct=rng.standard_normal((2, 10, 3)).astype(np.float32))
    return dict(mat=mat, mask=mask, x=x, ct=ct, x_bad=x_bad,
                mask_bad=mask_bad, topk=topk, rows=rows)


def _prop_rank(rank, case):
    """This rank's rows of A @ x and of its gradient under each edge mask,
    and the top-k of each case."""
    mesh = make_mesh((1, 2), "cpu")
    out = {}
    try:
        make_mesh((2, 2), "cpu")
    except ValueError as e:
        out["mismatch"] = str(e)
    g = ShardedPropGraph(mesh, case["mat"], device="cpu")
    rows = slice(rank * g.rows_per_shard, (rank + 1) * g.rows_per_shard)
    for tag, x, mask in (("plain", case["x"], None),
                         ("masked", case["x"], case["mask"]),
                         ("nonfinite", case["x_bad"], case["mask_bad"])):
        xl = pad_rows(torch.from_numpy(x), g.graph)[rows].requires_grad_()
        ct = pad_rows(torch.from_numpy(case["ct"]), g.graph)[rows]
        y = propagate(g, xl, None if mask is None
                      else torch.from_numpy(mask))
        torch.sum(y * ct).backward()
        out[tag] = (y.detach().numpy(), xl.grad.numpy())
    out["topk"] = []
    for c in case["topk"]:
        vals, ids = sharded_dot_topk(
            mesh, torch.from_numpy(c["uv"]), torch.from_numpy(c["items"]),
            torch.from_numpy(c["bias"]), c["k"], c["n_items"],
            torch.from_numpy(c["train"]))
        out["topk"].append((vals.numpy(), ids.numpy()))
    out["axes"] = _axes(rank, **case["rows"])
    return out


def _axes(rank, table, ids, ct):
    """lookup_rows over a model axis of 2 and a data axis of 2 (rows of
    ``ids`` by data index), gather_all_rows and global_batch_from_local on
    the (2, 1) mesh: the values and this rank's gradients."""
    out = {}
    mesh = make_mesh((1, 2), "cpu")
    blocks = model_row_sharding(mesh, table.shape[0])
    local = take_rows(torch.from_numpy(table), blocks).requires_grad_()
    y = lookup_rows(local, torch.from_numpy(ids[0]), blocks, mesh)
    torch.sum(y * torch.from_numpy(ct[0, :7])).backward()
    out["model"] = (y.detach().numpy(),
                    gather_rows(local.grad, blocks).numpy())
    mesh = make_mesh((2, 1), "cpu")
    blocks = model_row_sharding(mesh, table.shape[0])      # whole table
    local = take_rows(torch.from_numpy(table), blocks).requires_grad_()
    y = lookup_rows(local, torch.from_numpy(ids[rank]), blocks, mesh)
    torch.sum(y * torch.from_numpy(ct[rank, :7])).backward()
    out["data"] = (y.detach().numpy(), local.grad.numpy())
    block = torch.from_numpy(table[rank * 5:(rank + 1) * 5]).requires_grad_()
    whole = gather_all_rows(block, mesh)
    torch.sum(whole * torch.from_numpy(ct[rank])).backward()
    out["gather"] = (whole.detach().numpy(), block.grad.numpy())
    out["batch"] = global_batch_from_local(
        mesh, torch.from_numpy(ids[rank])).numpy()
    return out


@pytest.fixture(scope="module")
def ranks():
    case = _inputs()
    return case, run_ranks(_prop_rank, 2, (case,), timeout=240)


@pytest.fixture(scope="module")
def jax_prop(ranks):
    """JAX's sharded propagate on a (1, 2) mesh (local "mxu" kernel, in
    interpret mode) and its gradient, for each case of the ranks."""
    jax = _jax()
    import jax.numpy as jnp
    from skrx.parallel import (make_mesh as jax_mesh, make_sharded_propagate,
                               pad_rows as jax_pad,
                               sharded_graph_from_sp_matrix as jax_graph)
    case, _ = ranks
    mesh = jax_mesh((1, 2), jax.devices()[:2])
    sg = jax_graph(case["mat"], 2)
    prop = make_sharded_propagate(mesh, sg, axis=("data", "model"),
                                  local_impl="mxu", block_k=32, window=8,
                                  sp_matrix=case["mat"])
    ct = jax_pad(jnp.asarray(case["ct"]), sg)

    @jax.jit
    def run(xp, m):
        return prop(xp, m), jax.grad(lambda a: jnp.sum(prop(a, m) * ct))(xp)

    x0 = case["x"].copy()
    x0[0] = 0.0                 # the non-finite row, zeroed
    ones = np.ones_like(case["mask"])
    out = {}
    for tag, x, mask in (("plain", case["x"], ones),
                         ("masked", case["x"], case["mask"]),
                         ("nonfinite", x0, case["mask_bad"])):
        y, g = run(jax_pad(jnp.asarray(x), sg), jnp.asarray(mask))
        out[tag] = (np.asarray(y), np.asarray(g))
    return out


@pytest.mark.parametrize("kind,shards", [("sp", 2), ("sp", 3), ("coo", 2),
                                         ("coo", 3), ("empty", 2),
                                         ("empty", 3)])
def test_sharded_graph_arrays_equal_jax(kind, shards):
    _jax()
    from skrx.parallel import sharded_graph_from_coo as jax_coo
    from skrx.parallel import sharded_graph_from_sp_matrix as jax_sp
    if kind == "empty":
        mat = sp.csr_matrix((N, N), dtype=np.float32)
        got, ref = (sharded_graph_from_sp_matrix(mat, shards),
                    jax_sp(mat, shards))
    elif kind == "sp":
        mat = _random_sparse(N, 0.15, 3)
        got, ref = (sharded_graph_from_sp_matrix(mat, shards),
                    jax_sp(mat, shards))
    else:   # edges in a given order, repeated pairs included
        rng = np.random.default_rng(shards)
        src, dst = rng.integers(0, N, 90), rng.integers(0, N, 90)
        w = rng.random(90).astype(np.float32)
        got = sharded_graph_from_coo(src, dst, w, N, shards)
        ref = jax_coo(src, dst, w, N, shards)
    for field in ("src", "dst_local", "weight", "edge_id"):
        a, b = getattr(got, field), np.asarray(getattr(ref, field))
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert (got.num_nodes, got.rows_per_shard, got.num_shards,
            got.padded_nodes) == (ref.num_nodes, ref.rows_per_shard,
                                  ref.num_shards, ref.padded_nodes)
    x = torch.ones(N, 3)
    assert pad_rows(x, got).shape[0] == got.padded_nodes
    assert torch.equal(unpad_rows(pad_rows(x, got), got), x)


def test_make_mesh_raises_on_a_mismatched_world(ranks):
    with pytest.raises(ValueError, match="does not match 1 ranks"):
        make_mesh((1, 2), "cpu")
    _, out = ranks
    for r in out:
        assert "mesh shape (2, 2) does not match 2 ranks" in r["mismatch"]


@pytest.mark.parametrize("tag", ["plain", "masked"])
def test_sharded_propagate_matches_jax(ranks, jax_prop, tag):
    """Each rank's rows of A @ x and of dL/dx, concatenated, against JAX's
    sharded propagate on a (1, 2) mesh (local "mxu" kernel; "plain" is
    the port without a mask, JAX with a mask of ones)."""
    case, out = ranks
    ref_y, ref_g = jax_prop[tag]
    y = np.concatenate([r[tag][0] for r in out])
    g = np.concatenate([r[tag][1] for r in out])
    np.testing.assert_allclose(y, ref_y, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g, ref_g, rtol=1e-5, atol=1e-6)


def test_masked_nonfinite_row_gives_exact_zeros(ranks, jax_prop):
    """A NaN row whose every edge is masked adds exact zeros: the output
    and gradient are finite and equal JAX's run with that row zeroed."""
    case, out = ranks
    y = np.concatenate([r["nonfinite"][0] for r in out])
    g = np.concatenate([r["nonfinite"][1] for r in out])
    assert np.isfinite(y).all() and np.isfinite(g[1:]).all()
    ref_y, ref_g = jax_prop["nonfinite"]
    np.testing.assert_allclose(y, ref_y, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g, ref_g, rtol=1e-5, atol=1e-6)
    # rows whose every incoming edge weighs 0 are exact zeros
    mat = sp.csr_matrix(case["mat"])
    eff = sp.csr_matrix((mat.data * case["mask_bad"], mat.indices,
                         mat.indptr), shape=mat.shape)
    dead = np.asarray(abs(eff).sum(axis=1)).ravel() == 0
    assert dead[5]
    assert (y[:N][dead] == 0).all()


@pytest.mark.parametrize("which", [0, 1], ids=["k_above_shard", "wide"])
def test_sharded_dot_topk_matches_jax(ranks, which):
    """Both ranks return JAX's two-stage top-k (Pallas kernels, interpret
    mode) on a (1, 2) mesh: values equal, ids equal where the value is
    finite (the empty slots' ids differ by route, ROADMAP.md)."""
    jax = _jax()
    import jax.numpy as jnp
    from skrx.parallel import make_mesh as jax_mesh
    from skrx.parallel import sharded_dot_topk as jax_topk
    case, out = ranks
    c = case["topk"][which]
    ref_v, ref_i = jax_topk(jax_mesh((1, 2), jax.devices()[:2]),
                            jnp.asarray(c["uv"]), jnp.asarray(c["items"]),
                            jnp.asarray(c["bias"]), c["k"], c["n_items"],
                            jnp.asarray(c["train"]), {}, use_pallas=True)
    ref_v, ref_i = np.asarray(ref_v), np.asarray(ref_i)
    for vals, ids in (r["topk"][which] for r in out):
        assert vals.shape == ref_v.shape == (c["uv"].shape[0], c["k"])
        np.testing.assert_array_equal(vals, ref_v)
        finite = np.isfinite(ref_v)
        np.testing.assert_array_equal(ids[finite], ref_i[finite])
        for row, seen, ok in zip(ids, c["train"], finite):
            assert not np.isin(row[ok], seen).any()
    assert np.isneginf(ref_v).any() == (which == 0)


def test_lookup_and_gather_sum_gradients_over_the_data_axis(ranks):
    """lookup_rows on (1, 2) and (2, 1), gather_all_rows and
    global_batch_from_local on (2, 1): the rows read and the gradient of
    the summed loss of both data indices, as one process computes them."""
    case, ranks_out = ranks
    table, ids, ct = (case["rows"][k] for k in ("table", "ids", "ct"))
    out = [r["axes"] for r in ranks_out]
    t = torch.from_numpy(table).requires_grad_()
    torch.sum(t[torch.from_numpy(ids[0])] * torch.from_numpy(ct[0, :7])
              ).backward()
    for r in out:
        np.testing.assert_array_equal(r["model"][0], table[ids[0]])
        np.testing.assert_allclose(r["model"][1], t.grad.numpy(), rtol=1e-6)
    t.grad = None
    sum(torch.sum(t[torch.from_numpy(ids[i])] * torch.from_numpy(ct[i, :7]))
        for i in range(2)).backward()
    for rank, r in enumerate(out):
        np.testing.assert_array_equal(r["data"][0], table[ids[rank]])
        np.testing.assert_allclose(r["data"][1], t.grad.numpy(), rtol=1e-6)
        np.testing.assert_array_equal(r["gather"][0], table)
        np.testing.assert_allclose(
            r["gather"][1], (ct[0] + ct[1])[rank * 5:(rank + 1) * 5],
            rtol=1e-6)
        np.testing.assert_array_equal(r["batch"], ids.reshape(-1))


def test_row_blocks_cover_each_table_once():
    """A table split over 3 ranks (-(-n // 3) rows a block, the last
    short) and two tables in one node layout over 2 ranks: the blocks
    tile each table in order, and take/gather round-trip."""
    b = row_blocks(10, 3, 0, None)
    assert b.bounds == ((0, 4), (4, 8), (8, 10))
    full = torch.arange(10.0)
    assert torch.equal(take_rows(full, b._replace(index=2)), full[8:10])
    users = row_blocks(5, 2, 0, None, offset=0, span=12)
    items = row_blocks(7, 2, 1, None, offset=5, span=12)
    assert users.bounds == ((0, 5), (5, 5))
    assert items.bounds == ((0, 1), (1, 7))
    assert gather_rows(full, None) is full
