"""The port's TF-style GRU cell and attention ops against
``skrx/ops/rnn.py`` and ``skrx/ops/attention.py`` on the same inputs from
a numpy seed, f32 at rtol 1e-5 / atol 1e-6: ``gru_step`` with tanh and
relu, ``stacked_gru_step`` over three layers, ``layer_norm``, the
attention with and without causality on rows whose keys or queries sum to
zero (the key mask and the post-softmax query mask) with the dropout mask
JAX draws, the FFN, and a bf16 attention within 2e-2. The cell is not
``torch.nn.GRUCell``: with the same weights the two differ; and no
module of the sequence towers calls torch's recurrent layers or
``scaled_dot_product_attention``, which compute other functions."""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from skrx.ops import attention as jatt
from skrx.ops import rnn as jrnn
from skrx_torch.ops import attention, rnn

TOL = dict(rtol=1e-5, atol=1e-6)


def _np(rng, *shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _cell(rng, n_in, hid):
    return {"gate_w": _np(rng, n_in + hid, 2 * hid),
            "gate_b": _np(rng, 2 * hid) + 1.0,
            "cand_w": _np(rng, n_in + hid, hid), "cand_b": _np(rng, hid)}


def _t(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("act", ["tanh", "relu"])
def test_gru_step_matches_jax(act):
    rng = np.random.default_rng(1)
    p, x, h = _cell(rng, 5, 7), _np(rng, 6, 5), _np(rng, 6, 7)
    jact = jnp.tanh if act == "tanh" else jax.nn.relu
    ref = jrnn.gru_step(_j(p), jnp.asarray(x), jnp.asarray(h), jact)
    got = rnn.gru_step(_t(p), torch.from_numpy(x), torch.from_numpy(h),
                       rnn.ACTIVATIONS[act])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_stacked_gru_step_matches_jax_and_is_not_torch_grucell():
    rng = np.random.default_rng(2)
    widths = [6, 4, 3]
    cells = [_cell(rng, 5 if i == 0 else widths[i - 1], w)
             for i, w in enumerate(widths)]
    x = _np(rng, 4, 5)
    states = [_np(rng, 4, w) for w in widths]
    ref_out, ref_states = jrnn.stacked_gru_step(
        _j(cells), jnp.asarray(x), [jnp.asarray(s) for s in states])
    out, new = rnn.stacked_gru_step(_t(cells), torch.from_numpy(x),
                                    [torch.from_numpy(s) for s in states])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    for g, r in zip(new, ref_states):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    # torch's GRUCell with the same weights ([r, u] -> torch's [r, z], the
    # candidate's x and h parts) computes another function
    p = _t(cells[0])
    cell = torch.nn.GRUCell(5, 6)
    gw, cw = p["gate_w"], p["cand_w"]
    with torch.no_grad():
        cell.weight_ih.copy_(torch.cat([gw[:5].T, cw[:5].T]))
        cell.weight_hh.copy_(torch.cat([gw[5:].T, cw[5:].T]))
        cell.bias_ih.copy_(torch.cat([p["gate_b"], p["cand_b"]]))
        cell.bias_hh.zero_()
        theirs = cell(torch.from_numpy(x), torch.from_numpy(states[0]))
    assert (theirs - new[0]).abs().max() > 1e-3


def test_gru_init_has_tf_layout():
    p = rnn.gru_init(torch.Generator().manual_seed(0), 5, 7)
    assert p["gate_w"].shape == (12, 14) and p["cand_w"].shape == (12, 7)
    assert (p["gate_b"] == 1).all() and (p["cand_b"] == 0).all()
    limit = np.sqrt(6.0 / (12 + 14))
    assert float(p["gate_w"].abs().max()) <= limit


def test_layer_norm_and_dense_match_jax():
    rng = np.random.default_rng(3)
    x, s, b = _np(rng, 3, 5, 8, scale=3.0), _np(rng, 8), _np(rng, 8)
    x[0, 0] = 2.5                               # a constant row: var 0
    ref = jatt.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    got = attention.layer_norm(torch.from_numpy(x), torch.from_numpy(s),
                               torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    p = {"w": _np(rng, 8, 4), "b": _np(rng, 4)}
    np.testing.assert_allclose(
        attention.dense(torch.from_numpy(x), _t(p)).numpy(),
        np.asarray(jatt.dense(jnp.asarray(x), _j(p))), **TOL)


def _attention_inputs(rng, b=3, t=6, c=8):
    lin = {n: {"w": _np(rng, c, c), "b": _np(rng, c)} for n in "qkv"}
    keys = _np(rng, b, t, c)
    keys[0, :2] = 0.0                           # padded keys: masked
    keys[1, 3] = 0.0
    queries = _np(rng, b, t, c)
    queries[0, 0] = 0.0                         # a zero query row
    queries[2, 4] = 0.0
    return lin, queries, keys


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", [1, 2])
def test_attention_matches_jax(causal, heads):
    rng = np.random.default_rng(4 + heads)
    lin, queries, keys = _attention_inputs(rng)
    key = jax.random.key(7)
    ref = jatt.multihead_attention_kyubyong(
        _j(lin), jnp.asarray(queries), jnp.asarray(keys), heads,
        causal=causal, dropout_rate=0.3, rng=key)
    keep = torch.from_numpy(np.array(jax.random.bernoulli(
        key, 0.7, (3, heads, 6, 6))))
    got = attention.multihead_attention_kyubyong(
        _t(lin), torch.from_numpy(queries), torch.from_numpy(keys), heads,
        causal=causal, dropout_rate=0.3, keep=keep)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # without dropout (evaluation); a zero query row is its residual alone
    ref = jatt.multihead_attention_kyubyong(
        _j(lin), jnp.asarray(queries), jnp.asarray(keys), heads,
        causal=causal)
    got = attention.multihead_attention_kyubyong(
        _t(lin), torch.from_numpy(queries), torch.from_numpy(keys), heads,
        causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(got[0, 0].numpy(), queries[0, 0])


def test_attention_in_bf16_within_its_tolerance():
    rng = np.random.default_rng(9)
    lin, queries, keys = _attention_inputs(rng)
    bf = jnp.bfloat16
    ref = jatt.multihead_attention_kyubyong(
        jax.tree_util.tree_map(lambda a: jnp.asarray(a, bf), lin),
        jnp.asarray(queries, bf), jnp.asarray(keys, bf), 2)
    got = attention.multihead_attention_kyubyong(
        jax.tree_util.tree_map(lambda a: torch.from_numpy(a).bfloat16(),
                               lin),
        torch.from_numpy(queries).bfloat16(),
        torch.from_numpy(keys).bfloat16(), 2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_feedforward_and_dropout_match_jax():
    rng = np.random.default_rng(5)
    p = {"ff1": {"w": _np(rng, 8, 8), "b": _np(rng, 8)},
         "ff2": {"w": _np(rng, 8, 8), "b": _np(rng, 8)}}
    x = _np(rng, 3, 6, 8)
    key = jax.random.key(3)
    ref = jatt.feedforward_conv1(_j(p), jnp.asarray(x), 0.4, key)
    k1, k2 = jax.random.split(key)
    keeps = [torch.from_numpy(np.array(jax.random.bernoulli(k, 0.6, x.shape)))
             for k in (k1, k2)]
    got = attention.feedforward_conv1(_t(p), torch.from_numpy(x), 0.4, keeps)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(
        attention.feedforward_conv1(_t(p), torch.from_numpy(x), 0.4).numpy(),
        np.asarray(jatt.feedforward_conv1(_j(p), jnp.asarray(x), 0.4)),
        **TOL)
    # dropout: the identity without a mask or a generator, or at rate 0
    xt = torch.from_numpy(x)
    assert attention.dropout(xt, 0.5) is xt
    assert attention.dropout(xt, 0.0, keeps[0]) is xt
    gen = torch.Generator().manual_seed(0)
    drawn = attention.dropout(xt, 0.5, generator=gen)
    kept = drawn != 0
    np.testing.assert_allclose(drawn[kept].numpy(), 2 * x[kept.numpy()],
                               rtol=1e-6)


def test_towers_use_no_library_recurrence_or_fused_attention():
    import ast
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "skrx_torch")
    files = [os.path.join(root, "ops", f) for f in ("rnn.py",
                                                    "attention.py")]
    files += [os.path.join(root, "models", f"{m}.py") for m in (
        "GRU4Rec", "GRU4RecPlus", "SASRec", "BERT4Rec", "SRGNN")]
    banned = {"GRU", "GRUCell", "RNN", "RNNCell", "LSTM", "_VF", "gru",
              "gru_cell", "scaled_dot_product_attention",
              "MultiheadAttention", "multi_head_attention_forward"}
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        names = {node.attr for node in ast.walk(tree)
                 if isinstance(node, ast.Attribute)}
        names |= {node.id for node in ast.walk(tree)
                  if isinstance(node, ast.Name)}
        assert not names & banned, f"{path} uses {names & banned}"
