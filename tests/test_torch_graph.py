"""Graph propagation (kernel #11's slice): the port's propagate, its
gradient, edge masks and bf16 messages against the JAX package's
``propagate_mxu`` in interpret mode, on numpy-seeded inputs; the segment
layout the CUDA kernel walks; the adjacency helpers against JAX's.

Tolerances: f32 sums in another order (JAX: a HIGHEST-precision one-hot
matmul; the port: ``index_add_`` on the CPU), so rtol 1e-5, atol 1e-6, and
the same for bf16 messages, whose messages both sides round identically.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import scipy.sparse as sp
import torch

from skrx.models.LightGCN import build_bipartite_adj as jax_bipartite_adj
from skrx.ops.pallas.segsum_mxu import (mxu_graph_from_coo,
                                        mxu_graph_from_sp_matrix,
                                        propagate_mxu, transpose_mxu_graph)
from skrx.utils.common import normalize_adj_matrix as jax_normalize
from skrx_torch.models.LightGCN import build_bipartite_adj
from skrx_torch.ops import graph as tg
from skrx_torch.ops.kernels import segsum as ss
from skrx_torch.utils import normalize_adj_matrix

RTOL, ATOL = 1e-5, 1e-6
MSG = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


def _random_sparse(n, density, seed, m=None):
    rng = np.random.default_rng(seed)
    shape = (n, n if m is None else m)
    dense = (rng.random(shape) < density) * rng.random(shape)
    return sp.csr_matrix(dense.astype(np.float32))


def _jax_fwd_grad(g, x, ct, mask=None):
    """JAX's propagate_mxu output and the gradient of sum(out * ct)."""
    m = None if mask is None else jnp.asarray(mask)
    out = propagate_mxu(g, jnp.asarray(x), m)
    grad = jax.grad(lambda xx: jnp.sum(propagate_mxu(g, xx, m)
                                       * jnp.asarray(ct)))(jnp.asarray(x))
    return np.asarray(out), np.asarray(grad)


def _port_fwd_grad(g, x, ct, mask=None):
    xt = torch.from_numpy(x).requires_grad_(True)
    m = None if mask is None else torch.from_numpy(mask)
    out = tg.propagate(g, xt, m)
    (out * torch.from_numpy(ct)).sum().backward()
    return out.detach().numpy(), xt.grad.numpy()


def _assert_close(got, ref):
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


# --------------------------------------------------------- parity with JAX

@pytest.mark.parametrize("msg", ["f32", "bf16"])
@pytest.mark.parametrize("seed,block_k,window,d", [(0, 64, 16, 8),
                                                   (1, 32, 32, 16)])
def test_forward_and_gradient_match_jax(msg, seed, block_k, window, d):
    rng = np.random.default_rng(seed)
    n = 150
    mat = _random_sparse(n, 0.06, seed)
    jg = mxu_graph_from_sp_matrix(mat, block_k=block_k, window=window,
                                  msg_dtype=MSG[msg][0])
    tgr = tg.graph_from_sp_matrix(mat, msg_dtype=MSG[msg][1])
    x = rng.standard_normal((n, d)).astype(np.float32)
    ct = rng.standard_normal((n, d)).astype(np.float32)
    _assert_close(_port_fwd_grad(tgr, x, ct), _jax_fwd_grad(jg, x, ct))
    if msg == "f32":
        np.testing.assert_allclose(_port_fwd_grad(tgr, x, ct)[0], mat @ x,
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("msg", ["f32", "bf16"])
def test_edge_mask_enters_both_directions_as_in_jax(msg):
    rng = np.random.default_rng(2)
    n, d = 120, 8
    mat = _random_sparse(n, 0.08, 2)
    jg = mxu_graph_from_sp_matrix(mat, block_k=64, window=16,
                                  msg_dtype=MSG[msg][0])
    tgr = tg.graph_from_sp_matrix(mat, msg_dtype=MSG[msg][1])
    mask = (rng.random(mat.nnz) > 0.3).astype(np.float32) / 0.7
    x = rng.standard_normal((n, d)).astype(np.float32)
    ct = rng.standard_normal((n, d)).astype(np.float32)
    _assert_close(_port_fwd_grad(tgr, x, ct, mask),
                  _jax_fwd_grad(jg, x, ct, mask))


def test_hub_row_spanning_many_segments_matches_jax():
    """Node 0 receives 20 x SEGMENT_EDGES + 7 edges: the kernel's layout
    cuts it into 21 segments that a merge adds."""
    rng = np.random.default_rng(3)
    n, hub = 3000, 20 * ss.SEGMENT_EDGES + 7
    src = np.concatenate([rng.integers(1, n, hub), rng.integers(0, n, 400)])
    dst = np.concatenate([np.zeros(hub, np.int64), rng.integers(1, 40, 400)])
    w = rng.random(len(src)).astype(np.float32)
    jg = mxu_graph_from_coo(src, dst, w, n, block_k=512, window=64)
    tgr = tg.graph_from_coo(src, dst, w, n)
    assert tgr.fwd.max_degree == hub
    assert tgr.fwd.num_partials >= 21
    x = rng.standard_normal((n, 8)).astype(np.float32)
    ct = rng.standard_normal((n, 8)).astype(np.float32)
    _assert_close(_port_fwd_grad(tgr, x, ct), _jax_fwd_grad(jg, x, ct))


def test_isolated_nodes_and_empty_windows_are_zero():
    mat = sp.csr_matrix((np.array([2.0], np.float32),
                         (np.array([0]), np.array([1]))), shape=(100, 100))
    jg = mxu_graph_from_sp_matrix(mat, block_k=32, window=16)
    out = tg.propagate(tg.graph_from_sp_matrix(mat), torch.ones((100, 4)))
    expected = np.zeros((100, 4), np.float32)
    expected[0] = 2.0
    np.testing.assert_array_equal(out.numpy(), expected)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(propagate_mxu(jg, jnp.ones((100, 4)))))


def test_masked_edges_block_nonfinite_source_rows():
    """A dropped edge adds an exact 0 even from an inf/NaN row, forward and
    backward, as in JAX."""
    mat = sp.csr_matrix(np.array([[0.0, 1.0], [1.0, 0.0]], np.float32))
    jg = mxu_graph_from_sp_matrix(mat, block_k=8, window=8)
    tgr = tg.graph_from_sp_matrix(mat)
    x = np.array([[np.nan, np.inf], [1.0, 2.0]], np.float32)
    mask = np.array([1.0, 0.0], np.float32)    # CSR order: drop 1 <- 0
    out = tg.propagate(tgr, torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_array_equal(out.numpy(), [[1.0, 2.0], [0.0, 0.0]])
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(propagate_mxu(jg, jnp.asarray(x),
                                              jnp.asarray(mask))))
    ct = np.array([[1.0, 1.0], [np.inf, np.nan]], np.float32)
    got = _port_fwd_grad(tgr, np.ones((2, 2), np.float32), ct, mask)[1]
    ref = _jax_fwd_grad(jg, np.ones((2, 2), np.float32), ct, mask)[1]
    np.testing.assert_array_equal(got, [[0.0, 0.0], [1.0, 1.0]])
    np.testing.assert_array_equal(got, ref)


def test_empty_graph_is_the_zero_operator():
    empty = (np.array([], np.int64), np.array([], np.int64),
             np.array([], np.float32))
    jg = mxu_graph_from_coo(*empty, 50, block_k=16, window=16)
    tgr = tg.graph_from_coo(*empty, 50)
    x = torch.ones((50, 4), requires_grad=True)
    out = tg.propagate(tgr, x)
    out.sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.zeros((50, 4)))
    np.testing.assert_array_equal(x.grad.numpy(), np.zeros((50, 4)))
    np.testing.assert_array_equal(
        out.detach().numpy(), np.asarray(propagate_mxu(jg, jnp.ones((50, 4)))))


@pytest.mark.parametrize("msg", ["f32", "bf16"])
def test_rectangular_operator_and_transpose_match_jax(msg):
    rng = np.random.default_rng(6)
    m, n, d, e = 90, 140, 8, 600
    rows, cols = rng.integers(0, m, e), rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32)
    jg = mxu_graph_from_coo(cols, rows, w, m, block_k=64, window=16,
                            msg_dtype=MSG[msg][0], num_src_nodes=n)
    tgr = tg.graph_from_coo(cols, rows, w, m, MSG[msg][1], num_src_nodes=n)
    x_i = rng.standard_normal((n, d)).astype(np.float32)
    ct = rng.standard_normal((m, d)).astype(np.float32)
    _assert_close(_port_fwd_grad(tgr, x_i, ct), _jax_fwd_grad(jg, x_i, ct))
    x_u = rng.standard_normal((m, d)).astype(np.float32)
    ct_i = rng.standard_normal((n, d)).astype(np.float32)
    _assert_close(_port_fwd_grad(tg.transpose_graph(tgr), x_u, ct_i),
                  _jax_fwd_grad(transpose_mxu_graph(jg), x_u, ct_i))
    with pytest.raises(ValueError):
        tg.propagate(tgr, torch.zeros((m, d)))       # x must be (n, D)


@pytest.mark.parametrize("combine", ["mean", "sum", "last"])
def test_propagate_layers_matches_jax(combine):
    from skrx.ops.graph import propagate_layers as jax_layers
    rng = np.random.default_rng(3)
    n, d = 100, 8
    mat = _random_sparse(n, 0.07, 3)
    jg = mxu_graph_from_sp_matrix(mat, block_k=64, window=16)
    x = rng.standard_normal((n, d)).astype(np.float32)
    ref = np.asarray(jax_layers(jg, jnp.asarray(x), 3, combine))
    got = tg.propagate_layers(tg.graph_from_sp_matrix(mat),
                              torch.from_numpy(x), 3, combine).numpy()
    # three layers grow the rows ~40x here: rounding scales with them
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=ATOL * np.abs(ref).max())
    with pytest.raises(ValueError):
        tg.propagate_layers(tg.graph_from_sp_matrix(mat),
                            torch.from_numpy(x), 3, "max")


def test_edge_dropout_keep_rate_and_scaling():
    keep = 0.7
    mask = tg.edge_dropout(torch.Generator().manual_seed(0), 200_000, keep)
    assert mask.dtype == torch.float32 and mask.shape == (200_000,)
    values = set(np.unique(mask.numpy()).tolist())
    assert values == {0.0, np.float32(1.0 / keep)}
    rate = float((mask > 0).float().mean())
    assert abs(rate - keep) < 4 * np.sqrt(keep * (1 - keep) / 200_000)
    assert torch.equal(mask, tg.edge_dropout(
        torch.Generator().manual_seed(0), 200_000, keep))
    assert torch.equal(tg.edge_dropout(torch.Generator(), 10, 1.0),
                       torch.ones(10))
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError):
            tg.edge_dropout(torch.Generator(), 10, bad)


# ------------------------------------------------- the kernel's layout

def _emulate_kernel(seg, x, mask=None):
    """The CUDA kernel's plan in numpy: each segment's sum over its edges,
    written to its row or to a partial slot, then the merge step."""
    w = seg.weight.numpy().copy()
    if mask is not None:
        w *= mask[seg.orig.numpy()]
    ptr, sdst, src = seg.seg_ptr.numpy(), seg.seg_dst.numpy(), seg.src.numpy()
    out = np.full((seg.num_nodes, x.shape[1]), np.nan, np.float32)
    part = np.full((seg.num_partials, x.shape[1]), np.nan, np.float32)
    for s in range(len(sdst)):
        e = slice(ptr[s], ptr[s + 1])
        acc = (x[src[e]] * w[e, None]).astype(np.float64).sum(0)
        if sdst[s] >= 0:
            out[sdst[s]] = acc
        else:
            part[-1 - sdst[s]] = acc
    out_t = torch.from_numpy(out)
    ss.segsum_merge_plain(torch.from_numpy(part), seg.merge_row,
                          seg.merge_ptr, out_t)
    return out_t.numpy()


@pytest.mark.parametrize("case", ["lightgcn", "hub", "rectangular", "empty"])
def test_segment_layout_covers_every_edge_once(case):
    rng = np.random.default_rng(11)
    if case == "lightgcn":
        pairs = np.stack([rng.integers(0, 60, 900), rng.zipf(1.6, 900) % 80],
                         axis=1)
        mat = build_bipartite_adj(np.unique(pairs, axis=0), 60, 80, "pre")
        g = tg.graph_from_sp_matrix(mat)
    elif case == "hub":
        e = 3 * ss.SEGMENT_EDGES + 1
        g = tg.graph_from_coo(rng.integers(0, 50, e), np.full(e, 7),
                              rng.random(e), 9, num_src_nodes=50)
    elif case == "rectangular":
        g = tg.graph_from_coo(rng.integers(0, 30, 500),
                              rng.integers(0, 20, 500), rng.random(500), 20,
                              num_src_nodes=30)
    else:
        g = tg.graph_from_coo(np.array([], np.int64), np.array([], np.int64),
                              np.array([], np.float32), 6)
    for seg in (g.fwd, g.bwd):
        ptr = seg.seg_ptr.numpy()
        assert ptr[0] == 0 and ptr[-1] == seg.src.shape[0]
        assert (np.diff(ptr) >= 0).all()
        assert (np.diff(ptr) <= ss.SEGMENT_EDGES).all()
        rows = seg.seg_dst.numpy()
        direct = rows[rows >= 0]
        merged = seg.merge_row.numpy()
        # every row written exactly once, by its warp or by the merge
        assert sorted(np.concatenate([direct, merged]).tolist()) == \
            list(range(seg.num_nodes))
        assert seg.merge_ptr.numpy()[-1] == seg.num_partials == \
            int((rows < 0).sum())
        x = rng.standard_normal((seg.num_src_nodes, 5)).astype(np.float32)
        mask = (rng.random(seg.src.shape[0]) > 0.4).astype(np.float32)
        for m in (None, mask):
            ref = ss.segsum_plain(seg, torch.from_numpy(x),
                                  None if m is None else torch.from_numpy(m))
            np.testing.assert_allclose(_emulate_kernel(seg, x, m),
                                       ref.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["hubs", "rows of 2 to 4 segments",
                                  "rectangular", "no hub rows", "empty"])
def test_merge_fields_map_every_partial_slot_to_its_row(case):
    """build_segments' merge table: partial slot p of merged row m lies in
    merge_ptr[m] .. merge_ptr[m + 1] - 1 (part_merge[p] == m), the slots of
    a row are its segments in order, the counts are merge_ptr's differences,
    and every arrival counter starts at 0; a graph without rows of several
    segments, and the empty graph, have none of these."""
    rng = np.random.default_rng(12)
    e = ss.SEGMENT_EDGES
    if case == "hubs":
        deg = np.array([3 * e + 1, 5, 0, e, e + 1, 40 * e])
    elif case == "rows of 2 to 4 segments":
        deg = rng.integers(e + 1, 4 * e + 1, 12)
    elif case == "rectangular":
        deg = np.array([0, 2 * e + 7, 9, e + 1])
    elif case == "no hub rows":
        deg = rng.integers(0, e + 1, 30)
    else:
        deg = np.zeros(7, np.int64)
    dst = np.repeat(np.arange(len(deg)), deg)
    n_src = 300 if case == "rectangular" else len(deg) + 50
    seg = tg.graph_from_coo(rng.integers(0, n_src, len(dst)), dst,
                            rng.random(len(dst)), len(deg),
                            num_src_nodes=n_src).fwd
    per_row = np.maximum(1, -(-deg // e))
    multi = np.flatnonzero(per_row > 1)
    part_merge, merge_ptr = seg.part_merge.numpy(), seg.merge_ptr.numpy()
    assert seg.part_merge.dtype == seg.merge_count.dtype == torch.int32
    np.testing.assert_array_equal(seg.merge_row.numpy(), multi)
    np.testing.assert_array_equal(np.diff(merge_ptr), per_row[multi])
    assert len(part_merge) == seg.num_partials == merge_ptr[-1]
    for m in range(len(multi)):
        assert (part_merge[merge_ptr[m]:merge_ptr[m + 1]] == m).all()
    np.testing.assert_array_equal(np.bincount(part_merge,
                                              minlength=len(multi)),
                                  np.diff(merge_ptr))
    assert seg.merge_count.shape == (len(multi),)
    assert not seg.merge_count.any()
    # the segments of rows of several segments come first, the rows of
    # most segments first, each row's segments side by side writing its
    # slots in order; then the other rows in row order
    sdst = seg.seg_dst.numpy()
    n_multi = seg.num_partials
    assert (sdst[:n_multi] < 0).all() and (sdst[n_multi:] >= 0).all()
    np.testing.assert_array_equal(sdst[n_multi:],
                                  np.flatnonzero(per_row == 1))
    slots = -1 - sdst[:n_multi]
    want = [np.arange(merge_ptr[m], merge_ptr[m + 1])
            for m in np.argsort(-np.diff(merge_ptr), kind="stable")]
    np.testing.assert_array_equal(
        slots, np.concatenate(want) if want else np.zeros(0, slots.dtype))
    ptr, dst_e = seg.seg_ptr.numpy(), seg.dst.numpy()
    rows = np.where(sdst >= 0, sdst, seg.merge_row.numpy()[
        part_merge[np.maximum(-1 - sdst, 0)]] if n_multi else sdst)
    for sg in range(len(sdst)):           # a segment's edges go to its row
        assert (dst_e[ptr[sg]:ptr[sg + 1]] == rows[sg]).all()
    rows_of_slots = np.repeat(multi, per_row[multi])
    np.testing.assert_array_equal(seg.merge_row.numpy()[part_merge],
                                  rows_of_slots)
    if case in ("no hub rows", "empty"):
        assert seg.num_partials == 0 and len(multi) == 0
        assert seg.merge_ptr.tolist() == [0]
    moved = seg.to("cpu")
    assert moved.part_merge is not None and not moved.merge_count.any()


def test_segsum_refuses_what_the_kernel_does_not_take():
    g = tg.graph_from_coo(np.array([0, 1]), np.array([1, 0]),
                          np.array([1.0, 1.0]), 2)
    for bad in (torch.zeros((2, ss.MAX_DIM + 1)), torch.zeros((2, 0)),
                torch.zeros((2, 4), dtype=torch.float64), torch.zeros(2)):
        with pytest.raises(ValueError):
            ss.segsum(g.fwd, bad)
    with pytest.raises(ValueError):
        ss.segsum(g.fwd, torch.zeros((2, 4)), torch.ones(3))
    with pytest.raises(ValueError):
        ss.segsum(g.fwd, torch.zeros((2, 4)), msg_dtype=torch.float16)
    with pytest.raises(ValueError):
        tg.graph_from_coo(np.array([0, 5]), np.array([1, 0]),
                          np.array([1.0, 1.0]), 2)


# --------------------------------------------------- adjacency helpers

@pytest.mark.parametrize("method", ["left", "symmetric"])
def test_normalize_adj_matrix_matches_jax(method):
    mat = _random_sparse(40, 0.1, 4).tolil()
    mat[3] = 0                                 # a row of degree 0
    mat = mat.tocsr()
    got, ref = normalize_adj_matrix(mat, method), jax_normalize(mat, method)
    assert got.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(got.toarray(), ref.toarray())
    with pytest.raises(ValueError):
        normalize_adj_matrix(mat, "right")


@pytest.mark.parametrize("adj_type", ["plain", "norm", "gcmc", "pre"])
def test_bipartite_adjacency_matches_jax(adj_type):
    rng = np.random.default_rng(5)
    pairs = np.unique(np.stack([rng.integers(0, 30, 300),
                                rng.integers(0, 45, 300)], axis=1), axis=0)
    got = build_bipartite_adj(pairs, 31, 47, adj_type)
    ref = jax_bipartite_adj(pairs, 31, 47, adj_type)
    assert got.shape == ref.shape == (78, 78) and got.dtype == ref.dtype
    np.testing.assert_array_equal(got.toarray(), ref.toarray())
    # one edge order in both packages: CSR of the same matrix
    np.testing.assert_array_equal(
        tg.graph_from_sp_matrix(got).fwd.src.numpy(),
        np.asarray(sp.coo_matrix(sp.csr_matrix(ref)).col))
