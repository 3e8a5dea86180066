"""Self-attention primitives of the sequential models: the port of
``skrx.ops.attention`` (SASRec's blocks; BERT4Rec builds its own from
``dense``, ``layer_norm`` and ``dropout``).

``multihead_attention_kyubyong`` keeps the reference's masking quirks: the
key mask is ``|sum(keys, -1)| > 0`` and the causal mask the lower
triangle, both filled with ``-(2**32) + 1`` before the softmax; the query
mask (``|sum(queries, -1)| > 0``) multiplies the probabilities *after*
the softmax; dropout acts on the probabilities; the residual adds
``queries``. ``scaled_dot_product_attention`` has no post-softmax query
mask and no such fill, so the products are ``torch.matmul``s and the
softmax ``torch.softmax``, as the JAX package's einsums.

Dropout is inverted (kept entries scaled by ``1 / (1 - rate)``). It takes
its keep mask as a tensor, so that a test can hand in the JAX package's;
without one it draws from a generator, and with neither (evaluation) it is
the identity.
"""
from typing import Mapping, Optional, Sequence

import torch

__all__ = ["NEG_BIG", "layer_norm", "dense", "dropout", "keep_mask",
           "multihead_attention_kyubyong", "feedforward_conv1"]

NEG_BIG = -(2.0 ** 32) + 1


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               epsilon: float = 1e-8) -> torch.Tensor:
    """Over the last axis, with the biased variance and ``epsilon`` inside
    the root."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    return scale * (x - mean) / torch.sqrt(var + epsilon) + bias


def dense(x: torch.Tensor, p: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """``x @ p["w"] + p["b"]``."""
    return torch.matmul(x, p["w"]) + p["b"]


def keep_mask(generator: torch.Generator, shape: Sequence[int],
              rate: float) -> torch.Tensor:
    """A bool keep mask of ``shape``, each entry kept with probability ``1
    - rate``."""
    return torch.rand(tuple(shape), generator=generator,
                      device=generator.device) < 1.0 - rate


def dropout(x: torch.Tensor, rate: float,
            keep: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout under ``keep`` (or a mask drawn from
    ``generator``); the identity when given neither, or at rate 0."""
    if rate <= 0.0 or (keep is None and generator is None):
        return x
    if keep is None:
        keep = keep_mask(generator, x.shape, rate)
    return torch.where(keep, x / (1.0 - rate), 0.0)


def multihead_attention_kyubyong(params: Mapping, queries: torch.Tensor,
                                 keys: torch.Tensor, num_heads: int,
                                 causal: bool = True,
                                 dropout_rate: float = 0.0,
                                 keep: Optional[torch.Tensor] = None,
                                 generator: Optional[torch.Generator] = None
                                 ) -> torch.Tensor:
    """(B, T, C) attention of ``queries`` over ``keys`` with ``params``'s
    ``q``, ``k`` and ``v`` layers; ``keep`` the (B, heads, T, T) dropout
    mask of the probabilities."""
    b, t, c = queries.shape
    hd = c // num_heads
    q = dense(queries, params["q"]).reshape(b, t, num_heads, hd)
    k = dense(keys, params["k"]).reshape(b, t, num_heads, hd)
    v = dense(keys, params["v"]).reshape(b, t, num_heads, hd)
    logits = torch.matmul(q.transpose(1, 2),
                          k.permute(0, 2, 3, 1)) / (hd ** 0.5)  # (B,H,T,T)
    key_mask = torch.abs(torch.sum(keys, dim=-1)) > 0
    logits = torch.where(key_mask[:, None, None, :], logits, NEG_BIG)
    if causal:
        tril = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                     device=logits.device))
        logits = torch.where(tril[None, None], logits, NEG_BIG)
    probs = torch.softmax(logits, dim=-1)
    query_mask = (torch.abs(torch.sum(queries, dim=-1)) > 0).to(probs.dtype)
    probs = probs * query_mask[:, None, :, None]
    probs = dropout(probs, dropout_rate, keep, generator)
    out = torch.matmul(probs, v.transpose(1, 2))              # (B, H, T, hd)
    return out.transpose(1, 2).reshape(b, t, c) + queries


def feedforward_conv1(params: Mapping, x: torch.Tensor,
                      dropout_rate: float = 0.0,
                      keeps: Optional[Sequence[torch.Tensor]] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """The position-wise FFN (two 1x1 convolutions as ``ff1`` and ``ff2``
    layers), relu inside, dropout after each under ``keeps`` (two (B, T,
    C) masks), and the residual."""
    k1, k2 = keeps if keeps is not None else (None, None)
    h = torch.relu(dense(x, params["ff1"]))
    h = dropout(h, dropout_rate, k1, generator)
    h = dropout(dense(h, params["ff2"]), dropout_rate, k2, generator)
    return h + x
