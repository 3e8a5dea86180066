"""Propagation with traced per-edge weights (kernel #11's second caller):
the port's ``propagate_weighted`` against the JAX package's
``propagate_mxu_weighted`` in interpret mode, on a small directed graph
with repeated edges and rows without edges, numpy-seeded inputs: the
output, dx and dw. Tolerances: rtol 1e-5, atol 1e-6 for f32 messages and
the same for bf16 messages, whose messages both sides round identically
(the sums run in f32 in another order; dw is f32 on both sides). A
float64 ``gradcheck`` of the plain version; on a CUDA tensor the forward
and dx go to one segsum launch each and never to the plain version."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from skrx.ops.pallas.segsum_mxu import (propagate_mxu_weighted,
                                        weighted_mxu_graph_from_coo)
from skrx_torch.ops import graph as tg
from skrx_torch.ops.kernels import runtime
from skrx_torch.ops.kernels import segsum as ss

RTOL, ATOL = 1e-5, 1e-6
MSG = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


def _graph(seed, n=90, e=500):
    """e (a multiple of 5) directed edges with repeats (every 5th edge a
    copy of the next) and rows 0..9 without in-edges or out-edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(10, n, e)
    dst = rng.integers(10, n, e)
    src[::5], dst[::5] = src[1::5], dst[1::5]
    return rng, src, dst, n


def _jax_side(src, dst, n, x, w, ct, msg):
    g = weighted_mxu_graph_from_coo(src, dst, n, block_k=64, window=16,
                                    msg_dtype=MSG[msg][0])

    def loss(xx, ww):
        return jnp.sum(propagate_mxu_weighted(g, xx, ww) * jnp.asarray(ct))
    out = propagate_mxu_weighted(g, jnp.asarray(x), jnp.asarray(w))
    dx, dw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    return [np.asarray(a) for a in (out, dx, dw)]


def _port_side(src, dst, n, x, w, ct, msg):
    g = tg.weighted_graph_from_coo(src, dst, n, msg_dtype=MSG[msg][1])
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = tg.propagate_weighted(g, xt, wt)
    (out * torch.from_numpy(ct)).sum().backward()
    return [a.detach().numpy() for a in (out, xt.grad, wt.grad)]


@pytest.mark.parametrize("msg", ["f32", "bf16"])
@pytest.mark.parametrize("seed,d", [(0, 8), (1, 16)])
def test_propagate_weighted_matches_jax(msg, seed, d):
    rng, src, dst, n = _graph(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.random(len(src)).astype(np.float32)
    w[::7] = 0.0                                   # zero weights too
    ct = rng.standard_normal((n, d)).astype(np.float32)
    got = _port_side(src, dst, n, x, w, ct, msg)
    ref = _jax_side(src, dst, n, x, w, ct, msg)
    for name, a, b in zip(("out", "dx", "dw"), got, ref):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)
    assert not got[0][:10].any() and not got[1][:10].any()   # empty rows
    if msg == "f32":                   # the product it stands for
        dense = np.zeros((n, n), np.float64)
        np.add.at(dense, (dst, src), w)
        np.testing.assert_allclose(got[0], dense @ x, rtol=RTOL, atol=ATOL)


def test_propagate_weighted_gradcheck_of_the_plain_version(monkeypatch):
    """In float64 through segsum's plain version: dx and dw are the
    gradients of A(w) @ x."""
    monkeypatch.setattr(tg, "segsum", ss.segsum_plain)
    rng, src, dst, n = _graph(2, n=24, e=80)
    g = tg.weighted_graph_from_coo(src, dst, n)
    x = torch.from_numpy(rng.standard_normal((n, 3))).requires_grad_(True)
    w = torch.from_numpy(rng.random(len(src))).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda xx, ww: tg.propagate_weighted(g, xx, ww), (x, w))


def test_propagate_weighted_gives_only_the_gradients_asked_for():
    rng, src, dst, n = _graph(3, n=30, e=60)
    g = tg.weighted_graph_from_coo(src, dst, n)
    x = torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32))
    w = torch.from_numpy(rng.random(len(src)).astype(np.float32))
    w.requires_grad_(True)
    tg.propagate_weighted(g, x, w).sum().backward()
    assert w.grad is not None and x.grad is None
    np.testing.assert_allclose(
        w.grad.numpy(), x.numpy()[src].sum(1), rtol=RTOL, atol=ATOL)


def test_propagate_weighted_on_a_cuda_tensor_launches_segsum(monkeypatch):
    """With the device check answering 'cuda', the forward and dx are one
    segsum launch each (the weights passed as the edge scale) and the
    plain version is never reached."""
    def plain(*args, **kwargs):
        raise AssertionError("plain version reached")

    calls = []
    monkeypatch.setattr(ss, "on_cuda", lambda *t: True)
    monkeypatch.setattr(ss, "segsum_plain", plain)
    monkeypatch.setattr(ss, "launch", lambda name, dev, *a: calls.append(
        (name, a)))
    rng, src, dst, n = _graph(4, n=40, e=300)
    g = tg.weighted_graph_from_coo(src, dst, n)
    x = torch.zeros((n, 8), requires_grad=True)
    w = torch.from_numpy(rng.random(len(src)).astype(np.float32))
    w.requires_grad_(True)
    runtime.reset_launches()
    tg.propagate_weighted(g, x, w).sum().backward()
    assert [c[0] for c in calls] == ["skrx_segsum", "skrx_segsum"]
    assert all(c[1][8].data_ptr() == w.data_ptr() for c in calls)
    assert runtime.LAUNCHES["segsum"] == 2
    assert x.grad is not None and w.grad is not None
    runtime.reset_launches()
