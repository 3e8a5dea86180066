"""SRGNN — session-based recommendation with graph neural networks (Wu et
al., AAAI 2019): the port of ``skrx.models.SRGNN``.

Same config fields, defaults and checks, and the JAX package's parameters,
each U(-1/sqrt(d), 1/sqrt(d)) but ``nasr_b`` (zeros) and the TF GRU
cell's (``gru``, over 2d inputs): ``embedding`` (N, d), ``nasr_w1``,
``nasr_w2`` (d, d), ``nasr_v`` (1, d), ``nasr_b``, ``W_in``, ``b_in``,
``W_out``, ``b_out``, ``B`` (2d, d).

One training example per prefix of each user's time-ordered training items
(the prefix, cut to its last ``max_seq_len``, predicts the next item).
Each session is stored as its sorted unique items (``nodes``, padded with
N, whose embedding row reads as zero) and each position's index among them
(``alias``), built once on the host (:func:`prepare_sessions`, vectorised:
JAX loops over the sessions with ``np.unique`` and a dict). A step
(:func:`srgnn_session_embed`) scatters each session's transitions into a
(n_max, n_max) adjacency on the device (``scatter_reduce_`` with "amax":
the padded pairs write 0 at alias (0, 0) and must not clear a real 1),
normalises it by in- and out-degree, runs ``step`` gated-GNN
propagations through the GRU cell, reads the session out by attention
against its last item, and concatenates the attention with the
``nasr_w1``-projected last state through ``B`` (``nonhybrid`` keeps the
attention alone). The loss is the softmax cross-entropy over the catalog
plus ``l2_reg`` times half the squares of every parameter, then one Adam
step at a staircase exponential decay of the learning rate (``lr_dc``
every ``lr_dc_step`` epochs' worth of steps, by update count). Batches
follow JAX's two-level shuffle (:meth:`SRGNN.shuffled_order`: the
examples by length descending, in chunks of 32 batches, the chunks and
each chunk's examples shuffled by ``default_rng((seed, epoch))``), the
last partial batch dropped.

A user's vector is the session embedding of its last ``max_seq_len``
training items, and ``predict`` is ``uv @ embedding.T``: a tower
(``_topk_factors``: ``(uv, embedding, None)``).

Under a mesh SRGNN trains data-parallel: each rank takes its data index's
rows of every batch (the batch size must divide by the data axis), the
mean divides by the whole batch, the L2 term counts once and the
gradients sum over the data axis.
"""
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..convert import srgnn_params_from_jax
from ..ops.optim import staircase_exponential_decay
from ..ops.rnn import gru_init, gru_step
from ..parallel import (batch_mean, batch_total, data_sharding, local_rows,
                        once)
from ..run_config import RunConfig
from ..utils import ModelConfig
from .common import (CachedUserVecChunkMixin, NestedParamsMixin,
                     add_param_tree, adam_l2, gather_rows)
from .base import TorchRecommender

__all__ = ["SRGNN", "SRGNNConfig", "prefix_examples", "prepare_sessions",
           "session_adjacency", "srgnn_session_embed", "srgnn_loss"]


class SRGNNConfig(ModelConfig):
    lr: float = 1e-3
    l2_reg: float = 1e-5
    hidden_size: int = 64
    lr_dc: float = 0.1
    lr_dc_step: int = 3
    step: int = 1
    nonhybrid: bool = False
    max_seq_len: int = 200
    batch_size: int = 256
    epochs: int = 500
    early_stop: int = 50

    def _validate(self):
        ok = (isinstance(self.lr, float) and self.lr > 0
              and isinstance(self.l2_reg, float) and self.l2_reg >= 0
              and isinstance(self.hidden_size, int) and self.hidden_size > 0
              and isinstance(self.step, int) and self.step > 0
              and isinstance(self.nonhybrid, bool)
              and isinstance(self.max_seq_len, int) and self.max_seq_len > 0
              and isinstance(self.batch_size, int) and self.batch_size > 0)
        if not ok:
            raise ValueError(f"invalid SRGNN config: {self}")


def _flat_sessions(seqs) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(items int32, starts, ends) of the sessions ``seqs`` laid end to
    end."""
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    ends = np.cumsum(lens)
    items = np.concatenate(seqs) if seqs else np.zeros(0)
    return items.astype(np.int32), ends - lens, ends


def prefix_examples(user_pos, max_len: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray]:
    """The JAX package's training examples, users ascending and each
    user's from the longest prefix down: (items, the flat int32 training
    items; starts and ends (S,) int64, example s being ``items[starts[s]:
    ends[s]]``, at most ``max_len`` long; targets (S,) int32, the item
    after it)."""
    items, offsets, ends_of = _flat_sessions(list(user_pos.values()))
    lens = ends_of - offsets
    counts = np.maximum(lens - 1, 0)
    user = np.repeat(np.arange(len(lens)), counts)
    # example j of a user: i = j + 1, the prefix ends at len - i
    j = np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts,
                                            counts)
    end_in = lens[user] - (j + 1)
    ends = offsets[user] + end_in
    starts = offsets[user] + np.maximum(0, end_in - max_len)
    return items, starts, ends, items[ends]


def prepare_sessions(items: np.ndarray, starts: np.ndarray,
                     ends: np.ndarray, l_max: int, n_max: Optional[int],
                     pad_id: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(nodes (S, n_max) int32, alias (S, l_max) int32, lengths (S,)
    int32) of the sessions ``items[starts[s]:ends[s]]``: each session's
    sorted unique items padded with ``pad_id``, and each position's index
    among them, as the JAX package's ``_prepare_sessions`` (one sort over
    all the sessions' elements instead of a loop of ``np.unique``).
    ``n_max`` None: the most distinct items of one session."""
    s = len(starts)
    lengths = (ends - starts).astype(np.int64)
    total = int(lengths.sum())
    sess = np.repeat(np.arange(s, dtype=np.int64), lengths)
    pos = np.arange(total) - np.repeat(np.cumsum(lengths) - lengths, lengths)
    elem = items[np.repeat(starts, lengths) + pos].astype(np.int64)
    key = sess * (int(items.max(initial=0)) + 1) + elem
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    first = np.ones(total, dtype=bool)
    first[1:] = key_s[1:] != key_s[:-1]
    uniq = key_s[first]                          # (U,) ascending
    uniq_sess = sess[order][first]
    n_uniq = np.bincount(uniq_sess, minlength=s)
    rank = np.arange(len(uniq)) - np.repeat(np.cumsum(n_uniq) - n_uniq,
                                            n_uniq)
    if n_max is None:
        n_max = max(int(n_uniq.max(initial=0)), 1)
    nodes = np.full((s, n_max), pad_id, dtype=np.int32)
    nodes[uniq_sess, rank] = elem[order][first]
    alias = np.zeros((s, l_max), dtype=np.int32)
    first_of_sess = np.cumsum(n_uniq) - n_uniq
    alias[sess, pos] = np.searchsorted(uniq, key) - first_of_sess[sess]
    return nodes, alias, lengths.astype(np.int32)


def _pad_nodes(nodes: np.ndarray, width: int, pad_id: int) -> np.ndarray:
    out = np.full((nodes.shape[0], width), pad_id, dtype=nodes.dtype)
    out[:, :nodes.shape[1]] = nodes
    return out


def session_adjacency(alias: torch.Tensor, lengths: torch.Tensor,
                      n_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a_in, a_out) (B, n_max, n_max) f32: each session's transitions
    alias[t] -> alias[t + 1] (t < len - 1) as 0/1 entries, the columns of
    a_in divided by their sums (in-degree) and of a_out (the transpose) by
    the out-degree, each at least 1."""
    b, l_max = alias.shape
    valid = (torch.arange(l_max - 1, device=alias.device)[None, :]
             < (lengths[:, None] - 1)).float()
    flat = (torch.arange(b, device=alias.device)[:, None] * n_max * n_max
            + alias[:, :-1] * n_max + alias[:, 1:])
    adj = torch.zeros(b * n_max * n_max, device=alias.device)
    adj.scatter_reduce_(0, flat.reshape(-1), valid.reshape(-1), "amax")
    adj = adj.reshape(b, n_max, n_max)
    sum_in = torch.clamp(torch.sum(adj, dim=1), min=1.0)
    sum_out = torch.clamp(torch.sum(adj, dim=2), min=1.0)
    return adj / sum_in[:, None, :], adj.transpose(1, 2) / sum_out[:, None, :]


def srgnn_session_embed(p, cfg: SRGNNConfig, nodes: torch.Tensor,
                        alias: torch.Tensor, lengths: torch.Tensor
                        ) -> torch.Tensor:
    """(B, d) session embeddings of the batch's (nodes, alias, lengths)
    under the params tree ``p``."""
    b, n_max = nodes.shape
    l_max = alias.shape[1]
    d = cfg.hidden_size
    emb = p["embedding"]
    table = torch.cat([emb, emb.new_zeros((1, d))])
    fin = gather_rows(table, nodes)                          # (B, N, D)
    a_in, a_out = session_adjacency(alias, lengths, n_max)
    for _ in range(cfg.step):
        fin_in = fin @ p["W_in"] + p["b_in"]
        fin_out = fin @ p["W_out"] + p["b_out"]
        av = torch.cat([torch.matmul(a_in, fin_in),
                        torch.matmul(a_out, fin_out)], dim=-1)
        fin = gru_step(p["gru"], av.reshape(-1, 2 * d),
                       fin.reshape(-1, d)).reshape(b, n_max, d)
    rows = torch.arange(b, device=nodes.device)
    last_alias = alias[rows, torch.clamp(lengths - 1, min=0)]
    last_h = fin[rows, last_alias]
    seq_h = torch.gather(fin, 1, alias[:, :, None].expand(b, l_max, d))
    mask = (torch.arange(l_max, device=nodes.device)[None, :]
            < lengths[:, None]).float()
    last_proj = last_h @ p["nasr_w1"]
    m = torch.sigmoid(last_proj[:, None, :] + seq_h @ p["nasr_w2"]
                      + p["nasr_b"])
    coef = (m @ p["nasr_v"].T)[..., 0] * mask
    attn = torch.sum(coef[:, :, None] * seq_h, dim=1)
    if cfg.nonhybrid:
        return attn
    return torch.cat([attn, last_proj], dim=-1) @ p["B"]


def srgnn_loss(p, cfg: SRGNNConfig, nodes: torch.Tensor, alias: torch.Tensor,
               lengths: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """One batch's softmax cross-entropy over the catalog plus the
    ``l2_reg`` term over every parameter."""
    logits = srgnn_session_embed(p, cfg, nodes, alias, lengths) \
        @ p["embedding"].T
    ce = -torch.gather(torch.log_softmax(logits, dim=-1), 1,
                       targets[:, None])[:, 0]
    l2 = sum(0.5 * torch.sum(torch.square(x)) for x in _leaves(p))
    return batch_mean(ce) + cfg.l2_reg * once(l2)


def _leaves(tree) -> Sequence[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    values = tree.values() if isinstance(tree, dict) else tree
    return [leaf for v in values for leaf in _leaves(v)]


class SRGNN(NestedParamsMixin, CachedUserVecChunkMixin, TorchRecommender):

    def __init__(self, run_config: RunConfig, model_config: Dict,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(run_config, SRGNNConfig(**model_config), device)
        cfg = self.config
        n, d = self.num_items, cfg.hidden_size
        self.pad_id = n
        user_pos = self.dataset.train_data.to_user_dict_by_time()
        items, starts, ends, targets = prefix_examples(user_pos,
                                                       cfg.max_seq_len)
        # the test sessions: each user's last max_seq_len items, [0] for a
        # user without any
        t_items, t_starts, t_ends = _flat_sessions(
            [user_pos[u][-cfg.max_seq_len:] if u in user_pos
             else np.zeros(1, np.int32) for u in range(self.num_users)])
        self.num_examples = len(starts)
        l_max = int(max((ends - starts).max(initial=1),
                        (t_ends - t_starts).max()))
        tables = prepare_sessions(items, starts, ends, l_max, None, n)
        t_tables = prepare_sessions(t_items, t_starts, t_ends, l_max, None,
                                    n)
        # both padded to the wider node table, as JAX's global n_max
        n_max = max(tables[0].shape[1], t_tables[0].shape[1])
        self.l_max, self.n_max = l_max, n_max
        def put(x):
            return torch.as_tensor(x, device=self.device)
        self.nodes, self.alias, self.lengths = (
            put(_pad_nodes(tables[0], n_max, n)), put(tables[1]),
            put(tables[2]))
        self._lengths_np = tables[2]
        self.targets = put(targets)
        self.t_nodes, self.t_alias, self.t_lengths = (
            put(_pad_nodes(t_tables[0], n_max, n)), put(t_tables[1]),
            put(t_tables[2]))

        gen = torch.Generator().manual_seed(run_config.seed)
        stdv = 1.0 / math.sqrt(d)

        def uni(*shape):
            return (torch.rand(shape, generator=gen) * 2 - 1) * stdv
        self.batch_size = max(1, min(cfg.batch_size, self.num_examples))
        add_param_tree(self, {
            "embedding": uni(n, d), "nasr_w1": uni(d, d),
            "nasr_w2": uni(d, d), "nasr_v": uni(1, d),
            "nasr_b": torch.zeros(d), "W_in": uni(d, d), "b_in": uni(d),
            "W_out": uni(d, d), "b_out": uni(d), "B": uni(2 * d, d),
            "gru": gru_init(gen, 2 * d, d)}, self.device)
        decay_steps = max(int(cfg.lr_dc_step * self.num_examples
                              / cfg.batch_size), 1)
        self.lr_schedule = staircase_exponential_decay(cfg.lr, decay_steps,
                                                       cfg.lr_dc)
        self.optimizer = adam_l2(self.parameters(), cfg.lr)
        self.num_batches = self.num_examples // self.batch_size
        if self.mesh is not None:
            data_sharding(self.mesh, self.batch_size)    # it must divide

    # -------------------------------------------------------- training

    update_count = 0    # Adam updates taken: the schedule's count

    def _loss(self, nodes, alias, lengths, targets) -> torch.Tensor:
        return srgnn_loss(self.params_tree(), self.config, nodes.long(),
                          alias.long(), lengths.long(), targets.long())

    def train_step(self, batch) -> torch.Tensor:
        """One Adam step at the schedule's learning rate for this update."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_schedule(self.update_count)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._loss(*batch)
        loss.backward()
        self.sync_gradients()
        self.optimizer.step()
        self.update_count += 1
        return loss.detach()

    def shuffled_order(self, epoch: int) -> np.ndarray:
        """(S,) int32: the example order of epoch ``epoch``, as the JAX
        package's ``_shuffled_order``."""
        order = np.argsort(-self._lengths_np, kind="stable")
        chunk = self.config.batch_size * 32
        chunks = [order[i:i + chunk] for i in range(0, len(order), chunk)]
        rng = np.random.default_rng((self.run_config.seed, epoch))
        rng.shuffle(chunks)
        out = []
        for c in chunks:
            c = c.copy()
            rng.shuffle(c)
            out.append(c)
        return np.concatenate(out).astype(np.int32)

    def batches(self, epoch: int):
        """The batches (nodes, alias, lengths, targets) of epoch
        ``epoch``."""
        order = torch.as_tensor(self.shuffled_order(epoch).astype(np.int64),
                                device=self.device)
        b = self.batch_size
        for step in range(self.num_batches):
            idx = order[step * b:(step + 1) * b]
            yield (self.nodes[idx], self.alias[idx], self.lengths[idx],
                   self.targets[idx])

    def _train_epoch(self, epoch: int) -> Optional[float]:
        total = torch.zeros((), device=self.device)
        for batch in self.batches(epoch):
            total += self.train_step(local_rows(batch))
        return float(batch_total(total) / max(self.num_batches, 1))

    def _train_state(self) -> Dict:
        state = super()._train_state()
        state["update_count"] = self.update_count
        return state

    def _load_train_state(self, state: Dict) -> None:
        super()._load_train_state(state)
        self.update_count = int(state.get("update_count", 0))

    # ---------------------------------------------------------- scoring

    def _user_vectors(self, users: torch.Tensor) -> torch.Tensor:
        return srgnn_session_embed(self.params_tree(), self.config,
                                   self.t_nodes[users].long(),
                                   self.t_alias[users].long(),
                                   self.t_lengths[users].long())

    def _score_user_chunk(self, uv: torch.Tensor, item_lo: int,
                          item_hi: int) -> torch.Tensor:
        return uv @ self.embedding[item_lo:item_hi].T

    def _topk_factors(self, uv):
        return uv, self.embedding.detach(), None

    @torch.no_grad()
    def predict(self, users) -> torch.Tensor:
        """(B, N) f32 scores of the users' session embeddings."""
        return self.predict_chunk(users, 0, self.num_items)

    def load_jax_params(self, params: Dict) -> None:
        """Copy a JAX SRGNN's ``params`` (arrays taken with ``np.asarray``)
        into this model."""
        self._copy_params(srgnn_params_from_jax(params))
