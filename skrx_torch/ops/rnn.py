"""Recurrent cells of the session models: the port of ``skrx.ops.rnn``.

TensorFlow's ``GRUCell``, which GRU4Rec, GRU4RecPlus and SRGNN train with,
is not PyTorch's ``nn.GRUCell`` (nor cuDNN's GRU): its gate kernel acts on
``[x, h]`` with the gates in the order ``[r, u]``, the reset gate scales
``h`` *before* the candidate's product (``act([x, r*h] @ cand_w +
cand_b)``; PyTorch applies it after ``W_hn h``), the new state is ``u*h +
(1-u)*c``, and the gate bias starts at 1.0. So the cell here is two
``torch.matmul``s and elementwise ops, as the JAX package's; no library
recurrent kernel computes it.

A cell's parameters are a mapping (a dict or ``nn.ParameterDict``) of
``gate_w`` (in + hid, 2 hid), ``gate_b`` (2 hid,), ``cand_w`` (in + hid,
hid) and ``cand_b`` (hid,).
"""
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from .initializers import get_initializer

__all__ = ["gru_init", "gru_step", "stacked_gru_step", "ACTIVATIONS"]

ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "tanh": torch.tanh, "relu": torch.relu}


def gru_init(generator: Optional[torch.Generator], input_dim: int,
             hidden_dim: int) -> Dict[str, torch.Tensor]:
    """A cell's f32 CPU parameters in TF's layout: Glorot-uniform kernels
    (``jax.nn.initializers.glorot_uniform``), gate bias 1.0, candidate bias
    0."""
    glorot = get_initializer("xavier_uniform")
    return {
        "gate_w": glorot((input_dim + hidden_dim, 2 * hidden_dim), generator),
        "gate_b": torch.ones(2 * hidden_dim),
        "cand_w": glorot((input_dim + hidden_dim, hidden_dim), generator),
        "cand_b": torch.zeros(hidden_dim),
    }


def gru_step(params: Mapping[str, torch.Tensor], x: torch.Tensor,
             h: torch.Tensor,
             activation: Callable[[torch.Tensor], torch.Tensor] = torch.tanh
             ) -> torch.Tensor:
    """One step of the cell: x (B, in), h (B, hid) -> the new h (B,
    hid)."""
    gates = torch.sigmoid(torch.matmul(torch.cat([x, h], dim=-1),
                                       params["gate_w"]) + params["gate_b"])
    r, u = torch.chunk(gates, 2, dim=-1)
    c = activation(torch.matmul(torch.cat([x, r * h], dim=-1),
                                params["cand_w"]) + params["cand_b"])
    return u * h + (1.0 - u) * c


def stacked_gru_step(layer_params: Sequence[Mapping[str, torch.Tensor]],
                     x: torch.Tensor, states: Sequence[torch.Tensor],
                     activation: Callable[[torch.Tensor],
                                          torch.Tensor] = torch.tanh
                     ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Stacked cells, each fed the one below: (the top output, the new
    states)."""
    new_states = []
    inp = x
    for p, h in zip(layer_params, states):
        inp = gru_step(p, inp, h, activation)
        new_states.append(inp)
    return inp, new_states
