"""Carry trained JAX parameters and optimizer state into the port's
models.

The JAX package's arrays are taken as numpy arrays (``np.asarray`` of each
leaf), so this module needs no JAX.
"""
from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["bprmf_params_from_jax", "bprmf_adam_state_from_jax"]

_BPRMF_KEYS = ("user_emb", "item_emb", "item_bias")


def bprmf_params_from_jax(params: Dict[str, np.ndarray]
                          ) -> Dict[str, torch.Tensor]:
    """``{"user_emb": (U, d), "item_emb": (N, d), "item_bias": (N,)}`` f32
    CPU tensors from a JAX BPRMF's ``params``."""
    if set(params) != set(_BPRMF_KEYS):
        raise ValueError(f"expected keys {_BPRMF_KEYS}, got {sorted(params)}")
    out = {k: torch.from_numpy(np.array(params[k], dtype=np.float32))
           for k in _BPRMF_KEYS}
    u, i, b = out["user_emb"], out["item_emb"], out["item_bias"]
    if (u.dim() != 2 or i.dim() != 2 or b.dim() != 1
            or u.shape[1] != i.shape[1] or b.shape[0] != i.shape[0]):
        raise ValueError(f"inconsistent shapes: user_emb {tuple(u.shape)}, "
                         f"item_emb {tuple(i.shape)}, item_bias "
                         f"{tuple(b.shape)}")
    return out


def bprmf_adam_state_from_jax(count: int, mu: np.ndarray, nu: np.ndarray,
                              shapes: Dict[str, Tuple[int, ...]]
                              ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-parameter ``torch.optim.Adam`` state (``step``, ``exp_avg``,
    ``exp_avg_sq``, CPU tensors) from a JAX BPRMF's ``optax.adam`` state
    over its raveled parameters: ``count`` and the flat ``mu`` and ``nu``.
    ``ravel_pytree`` concatenates the leaves by sorted key (``item_bias``,
    ``item_emb``, ``user_emb``); ``shapes`` gives each leaf's shape.
    optax's count and torch's step both count the updates taken."""
    if set(shapes) != set(_BPRMF_KEYS):
        raise ValueError(f"expected keys {_BPRMF_KEYS}, got {sorted(shapes)}")
    mu = np.asarray(mu, dtype=np.float32).reshape(-1)
    nu = np.asarray(nu, dtype=np.float32).reshape(-1)
    total = sum(int(np.prod(s)) for s in shapes.values())
    if mu.shape != (total,) or nu.shape != (total,):
        raise ValueError(f"mu and nu must hold {total} values, got "
                         f"{mu.shape} and {nu.shape}")
    out, lo = {}, 0
    for key in sorted(shapes):
        size = int(np.prod(shapes[key]))
        out[key] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.from_numpy(
                mu[lo:lo + size].reshape(shapes[key]).copy()),
            "exp_avg_sq": torch.from_numpy(
                nu[lo:lo + size].reshape(shapes[key]).copy())}
        lo += size
    return out
