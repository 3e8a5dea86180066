"""The parts of ``chip_ab.py`` (the card's comparison of redesigned kernels
with a parent's) that run without a card: the hot-list layout it builds
for the experimental segsum kernel, and the ctypes signatures it calls the
parent's and the experiment's launchers with."""
import ctypes
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from skrx_torch.ops import graph as tg
from skrx_torch.ops.kernels import segsum as ss

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_ab():
    spec = importlib.util.spec_from_file_location(
        "chip_ab", os.path.join(ROOT, "chip_ab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _case(case: str, rng):
    """(src, dst, num_nodes, num_src_nodes, hot_rows) of a graph."""
    if case == "symmetric":        # a LightGCN-like bipartite graph, both ways
        users = rng.integers(0, 50, 700)
        items = 50 + rng.zipf(1.5, 700) % 70
        return (np.concatenate([users, items]),
                np.concatenate([items, users]), 120, 120, 16)
    if case == "empty":
        return np.array([], np.int64), np.array([], np.int64), 9, 9, 4
    if case == "fewer sources than H":
        return rng.integers(0, 6, 80), rng.integers(0, 30, 80), 30, 30, 64
    if case == "rectangular":
        return (rng.integers(0, 300, 2000), rng.integers(0, 40, 2000), 40,
                300, 25)
    # a hub of 3 segments whose sources are all hot, all cold or mixed;
    # sources 0..7 get extra out-edges elsewhere, so they are the hot ones
    e = 3 * ss.SEGMENT_EDGES + 5
    hub_src = {"hub all hot": rng.integers(0, 8, e),
               "hub all cold": rng.integers(40, 400, e),
               "hub mixed": rng.integers(0, 400, e)}[case]
    return (np.concatenate([hub_src, np.repeat(np.arange(8), 30)]),
            np.concatenate([np.zeros(e, np.int64), rng.integers(1, 20, 240)]),
            20, 400, 8)


CASES = ["symmetric", "empty", "fewer sources than H", "rectangular",
         "hub all hot", "hub all cold", "hub mixed"]


def _layout(case, seed):
    src, dst, n, n_src, h = _case(case, np.random.default_rng(seed))
    seg = tg.graph_from_coo(src, dst, np.ones(len(src)), n,
                            num_src_nodes=n_src).fwd
    enc, hot = _chip_ab().hot_layout(seg.src.numpy(), n_src, h)
    return seg, enc, hot, h


@pytest.mark.parametrize("case", CASES)
def test_hot_list_is_the_top_sources_by_out_degree(case):
    """The hot list holds the H source rows of most edges, most first, ties
    to the lower id, rows without edges left out."""
    seg, enc, hot, h = _layout(case, 21)
    deg = np.bincount(seg.src.numpy(), minlength=seg.num_src_nodes)
    ranked = sorted(np.flatnonzero(deg), key=lambda r: (-deg[r], r))
    assert hot.dtype == enc.dtype == np.int32
    assert hot.tolist() == ranked[:h]
    if case == "hub all hot":
        assert set(hot.tolist()) == set(range(8))


def test_symmetric_graph_has_one_hot_list_for_both_directions():
    src, dst, n, n_src, h = _case("symmetric", np.random.default_rng(21))
    g = tg.graph_from_coo(src, dst, np.ones(len(src)), n)
    hot_layout = _chip_ab().hot_layout
    fwd = hot_layout(g.fwd.src.numpy(), n, h)[1]
    bwd = hot_layout(g.bwd.src.numpy(), n, h)[1]
    np.testing.assert_array_equal(fwd, bwd)


@pytest.mark.parametrize("case", CASES)
def test_edge_encoding_round_trips_to_the_source_row(case):
    seg, enc, hot, _ = _layout(case, 22)
    src = seg.src.numpy()
    decoded = np.where(enc >= 0, enc, hot[np.maximum(-1 - enc, 0)])
    np.testing.assert_array_equal(decoded, src)
    is_hot = np.isin(src, hot)
    np.testing.assert_array_equal(enc < 0, is_hot)
    if case == "hub all cold":      # the hub's edges never touch the list
        assert (enc[seg.dst.numpy() == 0] >= 0).all()
    if case == "hub all hot":
        assert (enc[seg.dst.numpy() == 0] < 0).all()


@pytest.mark.parametrize("path,fn,attr", [
    ("skrx_torch/ops/kernels/csrc/segsum.cu", "skrx_segsum", "PARENT_SEGSUM"),
    ("experiments/segsum_hot_rows.cu", "skrx_segsum", "NEW_SEGSUM"),
    ("skrx_torch/ops/kernels/csrc/dot_topk.cu", "skrx_dot_extract",
     "EXTRACT"),
    ("skrx_torch/ops/kernels/csrc/dot_topk.cu", "skrx_dot_submax", "SUBMAX"),
    ("skrx_torch/ops/kernels/csrc/topk_blocks.cu", "skrx_kth_largest", "KTH"),
    ("experiments/kth_radix_select.cu", "skrx_kth_largest", "KTH"),
])
def test_launcher_signatures_match_the_c_declarations(path, fn, attr):
    """The argument types chip_ab.py gives each C launcher, the stream
    included, are the declaration's (the parent's segsum, dot_submax,
    dot_extract and kth_largest keep this tree's signatures)."""
    with open(os.path.join(ROOT, path)) as f:
        params = dict(re.findall(r"^int (skrx_\w+)\(([^)]*)\)", f.read(),
                                 re.M))[fn]
    want = [ctypes.c_void_p if "*" in p or "cudaStream_t" in p
            else ctypes.c_int for p in params.split(",")]
    assert getattr(_chip_ab(), attr) == want


def test_chip_ab_needs_a_card(monkeypatch):
    mod = _chip_ab()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["chip_ab.py", "--parent", "."])
    assert mod.main() == 2
