"""The train path's sums in one fixed order (``skrx_torch.ops.scatter``):
``ordered_row_sum`` and the gradient of ``gather_rows`` bit-equal to
``index_add_`` on the CPU (repeated ids, a hub of hundreds of repeats,
empty rows), ``gather_rows``' gradient equal to JAX's ``jax.grad`` of
``table[ids]`` (exactly on dyadic inputs, within 1e-6 relative on random
ones), the fixed index sets through kernel #11's plain version bit-equal
to ``index_add_``, SGAT's attention and LATTICE's learned-graph weights
bit-equal to their ``index_add`` form (values and gradients), SRGNN's
flattened sequence gather bit-equal to ``torch.gather``'s, the card's sum
above ``PUT_ROWS`` rows (sorted pieces) against float64, and, on a card,
two backward passes through each ordered sum with the same bits.

JAX is imported inside the tests that compare with it, so the card's test
run, which has no JAX, runs the rest of the file.
"""
import os

import numpy as np
import pytest
import torch

from skrx_torch import ModelRegistry, RunConfig
from skrx_torch.io import synthetic
from skrx_torch.models.LATTICE import lattice_item_weights
from skrx_torch.models.SGAT import build_sgat_graph, l2d, sgat_attention, \
    sgat_graph
from skrx_torch.models.common import gather_rows
from skrx_torch.ops import scatter
from skrx_torch.ops.attention import dense
from skrx_torch.ops.mm_graph import inv_sqrt_positive, l2_normalize

N_ROWS = 50


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().reshape(-1).view(torch.int32)


def _ids_and_rows(rng, k: int, width):
    """``k`` ids into N_ROWS rows (row 3 a hub of 300 repeats, rows 40 and
    up never hit) and rows of magnitudes 1e-6..1e5, so that the order of a
    sum shows in its bits."""
    ids = rng.integers(0, 40, k)
    ids[:300] = 3
    rng.shuffle(ids)
    shape = (k,) if width is None else (k, width)
    rows = (rng.standard_normal(shape)
            * 10.0 ** rng.integers(-6, 6, shape)).astype(np.float32)
    return torch.as_tensor(ids), torch.as_tensor(rows)


@pytest.mark.parametrize("width", [None, 7, 64, 300])
def test_ordered_row_sum_is_index_add_bit_for_bit(width):
    ids, rows = _ids_and_rows(np.random.default_rng(0), 700, width)
    ref = rows.new_zeros((N_ROWS, *rows.shape[1:])).index_add_(0, ids, rows)
    got = scatter.ordered_row_sum(ids, rows, N_ROWS)
    assert torch.equal(_bits(got), _bits(ref))
    assert not got[40:].any()                         # rows never hit
    # into a table in place: its rows first, then the batch's in order
    table = torch.as_tensor(np.random.default_rng(1).standard_normal(
        ref.shape).astype(np.float32))
    want = table.clone().index_add_(0, ids, rows)
    scatter.ordered_row_sum(ids, rows, N_ROWS, out=table)
    assert torch.equal(_bits(table), _bits(want))


@pytest.mark.parametrize("ids_shape", [(700,), (35, 20)])
@pytest.mark.parametrize("width", [None, 16])
def test_gather_rows_gradient_is_index_add_bit_for_bit(ids_shape, width):
    flat, cot = _ids_and_rows(np.random.default_rng(2), 700, width)
    ids = flat.reshape(ids_shape)
    shape = (N_ROWS,) if width is None else (N_ROWS, width)
    table = torch.randn(shape, requires_grad=True)
    out = gather_rows(table, ids)
    assert out.shape == (*ids_shape, *shape[1:])
    assert torch.equal(out, table.detach()[ids])
    out.backward(cot.reshape(out.shape))
    ref = torch.zeros(shape).index_add_(0, flat, cot)
    assert torch.equal(_bits(table.grad), _bits(ref))


@pytest.mark.parametrize("inputs", ["dyadic", "random"])
def test_gather_rows_gradient_matches_jax(inputs):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    ids = rng.integers(0, N_ROWS, (64, 12))
    ids[:, :4] = 5                                     # a hub
    if inputs == "dyadic":             # every partial sum exact in f32
        table = rng.integers(-64, 64, (N_ROWS, 8)).astype(np.float32) / 8
        cot = rng.integers(-64, 64, (64, 12, 8)).astype(np.float32) / 16
    else:
        table = rng.standard_normal((N_ROWS, 8)).astype(np.float32)
        cot = rng.standard_normal((64, 12, 8)).astype(np.float32)
    want = np.asarray(jax.grad(lambda t: jnp.sum(t[jnp.asarray(ids)]
                                                 * cot))(jnp.asarray(table)))
    t = torch.tensor(table, requires_grad=True)
    gather_rows(t, torch.as_tensor(ids)).backward(torch.as_tensor(cot))
    got = t.grad.numpy()
    if inputs == "dyadic":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("width", [None, 64, 300])
def test_fixed_sum_and_gather_are_index_add_bit_for_bit(width):
    ids, rows = _ids_and_rows(np.random.default_rng(4), 900, width)
    index = scatter.fixed_index(ids, N_ROWS)
    assert index.seg.merge_row.shape[0] >= 1         # the hub is merged
    ref = rows.new_zeros((N_ROWS, *rows.shape[1:])).index_add_(0, ids, rows)
    x = rows.clone().requires_grad_(True)
    summed = scatter.fixed_sum(x, index)
    assert torch.equal(_bits(summed), _bits(ref))
    cot = torch.randn(summed.shape)
    summed.backward(cot)
    assert torch.equal(x.grad, cot[ids])
    table = torch.randn(ref.shape, requires_grad=True)
    got = scatter.fixed_gather(table, index)
    assert torch.equal(got, table.detach()[ids])
    got.backward(rows)
    assert torch.equal(_bits(table.grad), _bits(ref))


def _sgat_attention_by_index_add(graph, items, user_emb):
    """SGAT's attention as the port computed it with ``index_add``."""
    h_e = (items.index_select(0, graph.occ_head)
           + user_emb.index_select(0, graph.occ_user))
    logit = -l2d(h_e, items.index_select(0, graph.occ_tail))
    lo, hi = torch.amin(logit), torch.amax(logit)
    exp_logit = torch.exp((logit - lo) / (hi - lo + 1e-12))
    edge_sum = exp_logit.new_zeros(graph.edge_tail.shape[0]).index_add(
        0, graph.occ_edge, exp_logit)
    row_sum = edge_sum.new_zeros(items.shape[0]).index_add(
        0, graph.edge_tail, edge_sum)
    return edge_sum / (row_sum + 1e-6).index_select(0, graph.edge_tail)


def test_sgat_attention_through_fixed_sets_is_index_add_form():
    rng = np.random.default_rng(5)
    n_items, n_users = 30, 25
    user_pos = {u: rng.integers(0, n_items, rng.integers(2, 40))
                for u in range(n_users)}
    user_pos[0] = np.array([7] * 200 + [8] * 100)      # hub edges
    graph = sgat_graph(build_sgat_graph(user_pos), n_items, n_users)
    results = []
    for attention in (sgat_attention, _sgat_attention_by_index_add):
        gen = torch.Generator().manual_seed(6)
        items = torch.randn((n_items, 8), generator=gen, requires_grad=True)
        users = torch.randn((n_users, 8), generator=gen, requires_grad=True)
        att = attention(graph, items, users)
        att.backward(torch.randn(att.shape, generator=gen))
        results.append((att, items.grad, users.grad))
    for got, ref in zip(*results):
        assert torch.equal(_bits(got), _bits(ref))


def _lattice_weights_by_index_add(p, cfg, item):
    """LATTICE's learned-graph weights with the row sums by ``index_add``
    (the port's form before the fixed index set)."""
    from skrx_torch.models.LATTICE import MODALITIES
    from skrx_torch.ops.mm_graph import knn_values
    weight = torch.softmax(p["modal_weight"], dim=0)
    present = [(feat, trs) for feat, trs in MODALITIES if feat in p]
    both = len(present) == 2
    learned = []
    for m, ((feat, trs), ids) in enumerate(zip(present, item.ids)):
        vals = knn_values(l2_normalize(dense(p[feat], p[trs])), item.rows,
                          ids.reshape(-1))
        learned.append(weight[m] * vals if both else vals)
    learned = torch.cat(learned)
    rows = item.rows.repeat(len(present))
    cols = torch.cat([i.reshape(-1) for i in item.ids])
    rowsum = torch.zeros(p[present[0][0]].shape[0], dtype=learned.dtype
                         ).index_add(0, rows, learned)
    d = inv_sqrt_positive(rowsum)
    lam = cfg.lambda_coeff
    learned = (1 - lam) * (learned * d[rows] * d[cols])
    return torch.cat([learned, *(lam * (weight[m] * v if both else v)
                                 for m, v in enumerate(item.orig_vals))])


def test_lattice_row_sum_through_fixed_set_is_index_add_form(tmp_path):
    os.chdir(tmp_path)
    data = synthetic.make_dataset_dir(str(tmp_path), num_users=40,
                                      num_items=60, num_ratings=900, seed=3,
                                      with_mm=True)
    reg = ModelRegistry()
    reg.load_skrx_model("LATTICE")
    m = reg.get_model("LATTICE")[0](
        RunConfig(data_dir=data, seed=2), dict(embed_dim=8, feat_embed_dim=8,
                                               knn_k=5), device="cpu")
    item = m.item_graph()
    assert m.item_graph().learned_rows is item.learned_rows     # laid out once
    results = []
    for weights in (lattice_item_weights, _lattice_weights_by_index_add):
        p = m.params_tree()
        w = weights(p, m.config, item)
        grads = torch.autograd.grad(
            w, [m.modal_weight, m.image_trs.w, m.text_trs.w, m.v_feat],
            torch.randn(w.shape, generator=torch.Generator().manual_seed(4)))
        results.append((w, *grads))
    for got, ref in zip(*results):
        assert torch.equal(_bits(got), _bits(ref))


def test_srgnn_flattened_gather_is_torch_gather_bit_for_bit():
    """SRGNN's session rows by ``gather_rows`` over the flattened (B N, D)
    table against ``torch.gather`` along the node axis, values and
    gradients (repeated nodes in a session sum in order)."""
    rng = np.random.default_rng(7)
    b, n_max, l_max, d = 6, 9, 15, 8
    alias = torch.as_tensor(rng.integers(0, 4, (b, l_max)))
    results = []
    for how in ("rows", "gather"):
        fin = torch.tensor(rng.standard_normal((b, n_max, d)).astype(
            np.float32) * 10.0 ** rng.integers(-5, 5, (b, n_max, d)),
            requires_grad=True) if how == "rows" else \
            results[0][0].detach().clone().requires_grad_(True)
        if how == "rows":
            rows = torch.arange(b)
            seq = gather_rows(fin.reshape(b * n_max, d),
                              alias + rows[:, None] * n_max)
        else:
            seq = torch.gather(fin, 1, alias[:, :, None].expand(b, l_max, d))
        cot = torch.as_tensor(np.random.default_rng(8).standard_normal(
            seq.shape).astype(np.float32))
        seq.backward(cot)
        results.append((fin, seq, fin.grad))
    assert torch.equal(_bits(results[0][1]), _bits(results[1][1]))
    assert torch.equal(_bits(results[0][2]), _bits(results[1][2]))


@pytest.mark.cuda
def test_cuda_backward_passes_are_bit_equal():
    """On a card: ``gather_rows``' gradient (ids of Zipf popularity, a hub
    of thousands) and ``fixed_gather``'s (kernel #11), at d = 64 and for a
    1-D table, each twice with the same bits and within 1e-5 of the
    summed magnitudes of float64 on the CPU (needs a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(9)
    ids = torch.as_tensor((rng.zipf(1.1, 20_000) - 1) % 5_000,
                          device="cuda")
    index = scatter.fixed_index(ids, 5_000)
    for shape in ((5_000, 64), (5_000,)):
        cot = torch.randn((20_000, *shape[1:]), device="cuda")
        ref = torch.zeros(shape, dtype=torch.float64).index_add_(
            0, ids.cpu(), cot.cpu().double())
        scale = torch.zeros(shape, dtype=torch.float64).index_add_(
            0, ids.cpu(), cot.cpu().double().abs())
        for gather in (gather_rows, lambda t, i: scatter.fixed_gather(
                t, index)):
            grads = []
            for _ in range(2):
                table = torch.zeros(shape, device="cuda", requires_grad=True)
                gather(table, ids).backward(cot)
                grads.append(table.grad)
            torch.cuda.synchronize()
            assert torch.equal(_bits(grads[0]), _bits(grads[1]))
            err = (grads[0].cpu().double() - ref).abs()
            assert bool((err <= 1e-5 * scale + 1e-30).all())


@pytest.mark.parametrize("k,width", [(6_400, 64), (9_000, None), (1, 3)])
def test_sum_in_pieces_matches_float64(k, width):
    """The card's sum above PUT_ROWS rows (sorted runs cut into pieces,
    two segment reductions), run here on CPU tensors: every row within
    1e-6 of its summed magnitudes of a float64 sum, rows never hit 0, a
    run of half the rows (longer than many pieces) included."""
    rng = np.random.default_rng(k)
    ids = rng.integers(0, 40, k)
    ids[: k // 2] = 39
    shape = (k,) if width is None else (k, width)
    rows = rng.standard_normal(shape).astype(np.float32)
    ref = np.zeros((N_ROWS,) + shape[1:])
    np.add.at(ref, ids, rows.astype(np.float64))
    scale = np.zeros_like(ref)
    np.add.at(scale, ids, np.abs(rows).astype(np.float64))
    got = scatter.sum_in_pieces(torch.as_tensor(ids), torch.as_tensor(rows),
                                N_ROWS).double().numpy()
    assert got.shape == ref.shape and not got[40:].any()
    assert np.all(np.abs(got - ref) <= 1e-6 * scale + 1e-30)
