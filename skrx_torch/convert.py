"""Carry trained JAX parameters into the port's models.

The JAX package's parameters are taken as numpy arrays (``np.asarray`` of
each leaf), so this module needs no JAX.
"""
from typing import Dict

import numpy as np
import torch

__all__ = ["bprmf_params_from_jax"]

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
