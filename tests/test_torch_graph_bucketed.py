"""The port's degree-bucketed propagation (``skrx_torch.ops.
graph_bucketed``) against the JAX package's ``propagate_bucketed``: the
same ``A @ x`` and the same gradient (through Aᵀ) within 1e-5, with
isolated rows and columns, one bucket and several, and the default caps;
its buckets against JAX's."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import scipy.sparse as sp
import torch

from skrx.ops import graph_bucketed as jgb
from skrx_torch.ops import graph_bucketed as tgb


def _matrix(rng, n, density, isolated):
    dense = (rng.random((n, n)) < density) * rng.random((n, n))
    dense[:isolated] = 0.0             # rows with no edge
    dense[:, n - isolated:] = 0.0      # columns with no edge
    return sp.csr_matrix(dense.astype(np.float32))


def _both(mat, caps, x, ct):
    """(JAX's out and grad, the port's) of sum(propagate(x) * ct)."""
    jg = jgb.bucketed_from_sp_matrix(mat, caps=caps)
    j_out = np.asarray(jgb.propagate_bucketed(jg, jnp.asarray(x)))
    j_grad = np.asarray(jax.grad(lambda v: jnp.sum(
        jgb.propagate_bucketed(jg, v) * jnp.asarray(ct)))(jnp.asarray(x)))
    tg = tgb.bucketed_from_sp_matrix(mat, caps=caps)
    xt = torch.tensor(x, requires_grad=True)
    t_out = tgb.propagate_bucketed(tg, xt)
    (t_out * torch.from_numpy(ct)).sum().backward()
    return (j_out, j_grad), (t_out.detach().numpy(), xt.grad.numpy()), \
        (jg, tg)


@pytest.mark.parametrize("seed,n,density,caps", [
    (0, 150, 0.06, (4, 16, 64)),
    (1, 150, 0.06, (4, 16, 64)),
    (2, 300, 0.02, tgb._DEFAULT_CAPS),
    (3, 64, 0.5, (2, 8)),
])
def test_value_and_gradient_equal_jax(seed, n, density, caps):
    rng = np.random.default_rng(seed)
    mat = _matrix(rng, n, density, isolated=7)
    d = 8
    x = rng.standard_normal((n, d)).astype(np.float32)
    ct = rng.standard_normal((n, d)).astype(np.float32)
    (j_out, j_grad), (t_out, t_grad), (jg, tg) = _both(mat, caps, x, ct)
    np.testing.assert_allclose(t_out, j_out, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_grad, j_grad, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_out, mat @ x, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t_grad, mat.T @ ct, rtol=1e-4, atol=1e-5)
    for jd, td in ((jg.fwd, tg.fwd), (jg.bwd, tg.bwd)):
        assert len(jd.nbr) == len(td.nbr)
        for a, b in zip(jd.nbr + jd.wts + (jd.inv_perm,),
                        td.nbr + td.wts + (td.inv_perm,)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_isolated_nodes_equal_jax():
    mat = sp.csr_matrix((np.array([2.0], np.float32),
                         (np.array([0]), np.array([1]))), shape=(10, 10))
    x = np.ones((10, 4), np.float32)
    ct = np.arange(40, dtype=np.float32).reshape(10, 4)
    (j_out, j_grad), (t_out, t_grad), _ = _both(mat, tgb._DEFAULT_CAPS, x,
                                                ct)
    expected = np.zeros((10, 4))
    expected[0] = 2.0
    np.testing.assert_array_equal(t_out, expected)
    np.testing.assert_array_equal(t_out, j_out)
    np.testing.assert_array_equal(t_grad, j_grad)
    assert t_grad[1].tolist() == [0.0, 2.0, 4.0, 6.0]
    empty = sp.csr_matrix((5, 5), dtype=np.float32)
    g = tgb.bucketed_from_sp_matrix(empty)
    assert torch.equal(tgb.propagate_bucketed(g, torch.ones(5, 3)),
                       torch.zeros(5, 3))
    with pytest.raises(ValueError):
        tgb.bucketed_from_sp_matrix(sp.csr_matrix((3, 4)))
